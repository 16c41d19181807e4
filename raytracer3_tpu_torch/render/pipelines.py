"""Frame pipelines (port of ``raytracer3_tpu/render/pipelines.py``) as plain
compositions of their passes; the reference's frame graph is a later slice.

Each factory returns ``(step, init_state)``; ``step(state, cam,
frame_index) -> (display, state)`` renders one frame, and ``init_state()``
gives the zeroed temporal buffers under the reference graph's names.

- ``wavefront_pipeline``: wavefront path tracing → progressive film (→
  à-trous denoiser with ``denoise=True``) → AgX.
- ``reference_pipeline``: the reference-mode tracer (``render_image``) →
  progressive film → AgX.
- ``probe_gi_pipeline``: packed G-buffer → SIS → probes → SH → interpolate
  → AgX, the probe atlas as temporal state.
- ``hybrid_gi_pipeline``: the same with per-pixel direct light over an
  indirect-only atlas, the direct term blended over time.

Frame 0 is a camera cut for the probe pipelines (the viewer restarts the
count on a move): the atlas takes blend factor 1 and drops its history.
Pass ``backend=`` (a TraceBackend) or the two trace functions.
"""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.render import denoise as denoise_mod
from raytracer3_tpu_torch.render import pathtracer, postprocess, probes, wavefront

_M32 = 0xFFFFFFFF


def _resolve_backend(backend, intersect_fn, occluded_fn):
    """(isect, occl): the backend's closures over its tables, else the two
    functions given."""
    if backend is not None:
        return backend.bind(backend.arrays)
    return intersect_fn, occluded_fn


def _progressive(render, h: int, w: int, device, denoise: bool = False):
    """(step, init_state) folding ``render(cam, frame_index)`` into a film
    with weight 1/(n+1), then AgX. With ``denoise`` ``render`` returns
    (radiance, (depth, normal)) and the display shows the film blended
    toward its à-trous filtered copy by ``denoise.denoise_strength`` of the
    new frame count (the film itself stays unfiltered)."""

    def init_state():
        return {
            "film": torch.zeros((h, w, 3), dtype=torch.float32, device=device),
            "frame_count": torch.zeros((), dtype=torch.float32, device=device),
        }

    def step(state, cam, frame_index):
        radiance = render(cam, frame_index)
        if denoise:
            radiance, (gb_depth, gb_normal) = radiance
        n = state["frame_count"]
        film = state["film"] + (radiance - state["film"]) * (1.0 / (n + 1.0))
        count = n + 1.0
        shown = film
        if denoise:
            filt = denoise_mod.atrous_filter(film, gb_depth, gb_normal)
            shown = film + (filt - film) * denoise_mod.denoise_strength(count)
        return postprocess.postprocess(shown), {"film": film, "frame_count": count}

    return step, init_state


def wavefront_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, sort_rays: bool = True,
                       backend=None, blue_noise=None, denoise: bool = False, *, device):
    """Production progressive path tracing: ``wavefront.render_frame`` →
    film → AgX. With ``backend=`` the primaries go through its
    ``bind_primary`` and, when ``settings.fuse_shadow`` is set, each
    bounce's shadow batch rides its next launch through ``bind_capped``
    (a backend without a capped trace takes the split path, as in the
    reference). ``denoise=True`` shows the film through the edge-aware
    à-trous filter (``render/denoise.py``), strong on shallow
    accumulation and fading out by 64 frames."""
    primary = fused = None
    if backend is not None:
        primary = backend.bind_primary(backend.arrays)
        if settings.fuse_shadow:
            fused = backend.bind_capped(backend.arrays)
    intersect_fn, occluded_fn = _resolve_backend(backend, intersect_fn, occluded_fn)

    def render(cam, frame_index):
        return wavefront.render_frame(scene, cam, settings, frame_index, intersect_fn, occluded_fn,
                                      sort_rays=sort_rays, blue_noise=blue_noise, return_gbuffer=denoise,
                                      primary_fn=primary, fused_fn=fused)

    return _progressive(render, settings.height, settings.width, torch.device(device), denoise)


def reference_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, backend=None, *, device):
    """Reference-mode ground truth (old/refrence_mode.slang): G-buffer →
    samples × bounces → film → AgX."""
    intersect_fn, occluded_fn = _resolve_backend(backend, intersect_fn, occluded_fn)

    def render(cam, frame_index):
        return pathtracer.render_image(scene, cam, settings, frame_index, intersect_fn, occluded_fn)

    return _progressive(render, settings.height, settings.width, torch.device(device))


def _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, hybrid: bool):
    device = torch.device(device)
    w, h = settings.width, settings.height
    px, py = settings.probe_grid
    r = settings.probe_res
    isect, occl = _resolve_backend(backend, intersect_fn, occluded_fn)
    primary = backend.bind_primary(backend.arrays) if backend is not None else None
    gi = probes.hybrid_gi_from_gbuffer if hybrid else probes.probe_gi_from_gbuffer

    def init_state():
        z = dict(dtype=torch.float32, device=device)
        state = {"probe_atlas": torch.zeros((py * r, px * r, 3), **z),
                 "probe_depth": torch.zeros((py * r, px * r), **z)}
        if hybrid:
            state["direct_hist"] = torch.zeros((h, w, 3), **z)
        return state

    def step(state, cam, frame_index):
        packed, _ = probes.trace_packed_gbuffer(scene, isect, cam, settings, primary_fn=primary)
        prev = probes.ProbeState(atlas=state["probe_atlas"], depth=state["probe_depth"],
                                 sh_coeffs=torch.zeros((py, px, 3, 9), dtype=torch.float32, device=device))
        bf = 1.0 if (int(frame_index) & _M32) == 0 else blendfactor
        light, st, aux = gi(scene, isect, cam, packed, prev, settings, frame_index,
                            blendfactor=bf, occluded_fn=occl)
        new = {"probe_atlas": st.atlas, "probe_depth": st.depth}
        if hybrid:
            # The per-pixel direct term is one NEE sample a frame: blend it
            # with the atlas's factor and cut, the indirect term is smoothed
            # inside the atlas already.
            prev_direct = state["direct_hist"]
            direct = prev_direct + ((light - aux["indirect"]) - prev_direct) * bf
            light = aux["indirect"] + direct
            new["direct_hist"] = direct
        return postprocess.postprocess(light), new

    return step, init_state


def probe_gi_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, blendfactor: float = 0.15,
                      backend=None, *, device):
    """The probe pipeline (SURVEY.md §3.5): packed G-buffer (tile-ordered
    primaries through the backend's ``bind_primary``) → SIS → trace_probes
    → SH → interpolate → AgX."""
    return _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, hybrid=False)


def hybrid_gi_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, blendfactor: float = 0.15,
                       backend=None, *, device):
    """Hybrid probes + path tracing (``probes.hybrid_gi_from_gbuffer``): the
    probe pipeline's shape with per-pixel direct NEE over an indirect-only
    atlas and a temporal ``direct_hist``."""
    return _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, hybrid=True)
