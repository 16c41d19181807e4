"""Frame pipelines (port of ``raytracer3_tpu/render/pipelines.py``), each
built on the frame graph (``graph/graph.py``) with the reference's
resources and pass names.

Each factory returns ``(step, init_state)``; ``step(state, cam,
frame_index) -> (display, state)`` renders one frame, and ``init_state()``
gives the graph's zeroed temporal resources on the pipeline's device.

- ``wavefront_pipeline``: trace (wavefront path tracing) → blend
  (progressive film) → post (à-trous denoiser with ``denoise=True``, AgX).
  Its state also counts the rays the frames traced (``rays_traced``).
- ``reference_pipeline``: trace (the reference-mode tracer,
  ``render_image``) → blend → post.
- ``probe_gi_pipeline``: the reference's probe passes, gbuffer (packed
  G-buffer) → sis (each probe's ray budget) → probe_trace (one ray a
  texel into the probe atlas, the temporal state) → sh (SH3 a probe) →
  interpolate (the lit image) → post. On a CUDA device sis, sh and
  interpolate are one hand-written kernel each (``csrc/probe_resolve.cu``).
- ``hybrid_gi_pipeline``: the same passes over an indirect-only atlas, with
  per-pixel direct light traced in probe_trace and blended over time in
  interpolate.

Frame 0 is a camera cut for the probe pipelines (the viewer restarts the
count on a move): the atlas takes blend factor 1 and drops its history.
Their state also counts the rays the frames traced (``rays_traced``) and
keeps the frame's lit image (``light``).
Pass ``backend=`` (a TraceBackend) or the two trace functions.

Each step is compiled with the reference's defaults (``FrameGraph.compile``
with ``jit=True``, ``donate_state=True``): on a CUDA device the frame runs
as one CUDA graph, and the state a step returns is the graph's own buffers.
Every backend of the port captures: K1-K4, and the oracle backends' walks
(``bvh``, ``cluster``, the wide BVH), which run as kernels that read
nothing back. A step whose trace functions read the device from the host
raises on its first call on the card, and ``jit=False`` runs it eagerly.
On the CPU every step runs eagerly.
"""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.graph import FrameGraph
from raytracer3_tpu_torch.ops import packing, rng
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import denoise as denoise_mod
from raytracer3_tpu_torch.render import gbuffer as gbuffer_mod
from raytracer3_tpu_torch.render import pathtracer, postprocess, probes, wavefront

def _resolve_backend(backend, intersect_fn, occluded_fn):
    """(isect, occl): the backend's closures over its tables, else the two
    functions given."""
    if backend is not None:
        return backend.bind(backend.arrays)
    return intersect_fn, occluded_fn


def _blend(r, cam, frame_index):
    """Fold the frame's radiance into the film with weight 1/(n+1)."""
    n = r["frame_count@prev"]
    return {"film": r["film@prev"] + (r["radiance"] - r["film@prev"]) * (1.0 / (n + 1.0)),
            "frame_count": n + 1.0}


def _frame_step(g: FrameGraph, jit: bool):
    """The graph's step for ``output="display"`` as ``step(state, cam,
    frame_index)``, compiled with the reference's defaults: on a CUDA device
    one CUDA graph (its state donated), whose frame index is a graph input."""
    run = g.compile(output="display", jit=jit)

    def step(state, cam, frame_index):
        return run(state, cam=cam, frame_index=frame_index)

    step.pass_order = run.pass_order
    return step


def _progressive(trace, h: int, w: int, device, denoise: bool = False, count_to_post: bool = True,
                 jit: bool = True, count_rays: bool = False):
    """trace → blend → post: ``trace(r, cam, frame_index)`` writes the
    frame's radiance (and with ``denoise`` the primary hits' depth and
    normal; with ``count_rays`` the temporal int64 ``rays_traced`` from
    ``rays_traced@prev``); post reads the film (and, as the reference's
    wavefront pipeline declares it, the frame count). The display shows the film, with
    ``denoise`` blended toward its à-trous filtered copy by
    ``denoise.denoise_strength`` of the new frame count (the film itself
    stays unfiltered)."""
    g = FrameGraph()
    g.image("radiance", (h, w, 3))
    g.temporal("film", (h, w, 3))
    g.temporal("frame_count", ())
    g.image("display", (h, w, 3))
    rays = ["rays_traced"] if count_rays else []
    if count_rays:
        g.temporal("rays_traced", (), dtype=torch.int64)
    gbuf = ["gbuf_depth", "gbuf_normal"] if denoise else []
    if denoise:
        g.image("gbuf_depth", (h, w))
        g.image("gbuf_normal", (h, w, 3))

    def post(r, cam, frame_index):
        film = r["film"]
        if denoise:
            filt = denoise_mod.atrous_filter(film, r["gbuf_depth"], r["gbuf_normal"])
            film = film + (filt - film) * denoise_mod.denoise_strength(r["frame_count"])
        return {"display": postprocess.postprocess(film)}

    g.add_pass("trace", trace, reads=[f"{r}@prev" for r in rays], writes=["radiance"] + rays + gbuf)
    g.add_pass("blend", _blend, reads=["radiance", "film@prev", "frame_count@prev"],
               writes=["film", "frame_count"])
    g.add_pass("post", post, reads=["film"] + (["frame_count"] if count_to_post else []) + gbuf,
               writes=["display"])
    return _frame_step(g, jit), lambda: g.init_state(device)


def wavefront_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, sort_rays: bool = True,
                       backend=None, blue_noise=None, denoise: bool = False, *, device, jit: bool = True):
    """Production progressive path tracing: ``wavefront.render_frame`` →
    film → AgX. With ``backend=`` the primaries go through its
    ``bind_primary`` and, when ``settings.fuse_shadow`` is set, each
    bounce's shadow batch rides its next launch through ``bind_capped``
    (a backend without a capped trace takes the split path, as in the
    reference). ``denoise=True`` shows the film through the edge-aware
    à-trous filter (``render/denoise.py``), strong on shallow
    accumulation and fading out by 64 frames. The state's ``rays_traced``
    (int64, 0-d) adds each frame's traced-ray count (``render_frame``'s
    ``return_stats``: primaries, alive closest-hit lanes and shadow lanes)
    on the device; nothing reads it back."""
    primary = fused = None
    if backend is not None:
        primary = backend.bind_primary(backend.arrays)
        if settings.fuse_shadow:
            fused = backend.bind_capped(backend.arrays)
    intersect_fn, occluded_fn = _resolve_backend(backend, intersect_fn, occluded_fn)

    def trace(r, cam, frame_index):
        out = wavefront.render_frame(scene, cam, settings, frame_index, intersect_fn, occluded_fn,
                                     sort_rays=sort_rays, blue_noise=blue_noise, return_stats=True,
                                     return_gbuffer=denoise, primary_fn=primary, fused_fn=fused)
        rad, traced = out[:2]
        res = {"radiance": rad, "rays_traced": r["rays_traced@prev"] + traced}
        if denoise:
            res["gbuf_depth"], res["gbuf_normal"] = out[2]
        return res

    return _progressive(trace, settings.height, settings.width, torch.device(device), denoise, jit=jit,
                        count_rays=True)


def reference_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, backend=None, *, device,
                       jit: bool = True):
    """Reference-mode ground truth (old/refrence_mode.slang): G-buffer →
    samples × bounces → film → AgX."""
    intersect_fn, occluded_fn = _resolve_backend(backend, intersect_fn, occluded_fn)

    def trace(r, cam, frame_index):
        return {"radiance": pathtracer.render_image(scene, cam, settings, frame_index, intersect_fn, occluded_fn)}

    return _progressive(trace, settings.height, settings.width, torch.device(device), count_to_post=False, jit=jit)


def _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, hybrid: bool,
                    jit: bool):
    device = torch.device(device)
    w, h = settings.width, settings.height
    px, py = settings.probe_grid
    r_ = settings.probe_res
    isect, occl = _resolve_backend(backend, intersect_fn, occluded_fn)
    primary = backend.bind_primary(backend.arrays) if backend is not None else None

    g = FrameGraph()
    # The G-buffer crosses passes packed: four uint32 words (int64 tensors)
    # and planar depth. Each word is decoded once a frame: sis decodes the
    # normals for every later pass, interpolate the albedo and emission.
    g.image("gbuf_data", (h, w, 4), dtype=torch.int64)
    g.image("gbuf_depth", (h, w))
    g.image("gbuf_normal", (h, w, 3))
    g.image("probe_dir", (py, px, r_ * r_), dtype=torch.int64)
    g.image("probe_mip", (py, px, r_ * r_), dtype=torch.int64)
    g.temporal("probe_atlas", (py * r_, px * r_, 3))
    g.temporal("probe_depth", (py * r_, px * r_))
    g.temporal("rays_traced", (), dtype=torch.int64)
    g.image("sh", (py, px, 3, 9))
    if hybrid:
        g.image("direct", (h, w, 3))
        g.temporal("direct_hist", (h, w, 3))
    # The lit image before AgX stays in the state, so that a frame function
    # can hand it on (the viewer's film); no pass reads it back.
    g.temporal("light", (h, w, 3))
    g.image("display", (h, w, 3))

    def cut_blend(frame_index):
        # Frame 0 is a camera cut: blend factor 1, the history dropped. A
        # compiled step's frame index is a tensor: the cut is selected on
        # the device.
        fw = rng.frame_word(frame_index)
        if isinstance(fw, torch.Tensor):
            return torch.where(fw == 0, 1.0, blendfactor)
        return 1.0 if fw == 0 else blendfactor

    def gbuffer(r, cam, frame_index):
        pk, _ = probes.trace_packed_gbuffer(scene, isect, cam, settings, primary_fn=primary)
        return {"gbuf_data": pk.data, "gbuf_depth": pk.depth}

    def sis(r, cam, frame_index):
        normal, dir_index, mip = probes.sis_packed(r["gbuf_data"], settings)
        return {"gbuf_normal": normal, "probe_dir": dir_index, "probe_mip": mip}

    def probe_trace(r, cam, frame_index):
        depth, normal = r["gbuf_depth"], r["gbuf_normal"]
        o, d = camera_mod.primary_rays(cam, w, h, pixel_xy=camera_mod.pixel_grid(w, h, device=device))
        o, d = o.reshape(h, w, 3), d.reshape(h, w, 3)
        prev = probes.ProbeState(atlas=r["probe_atlas@prev"], depth=r["probe_depth@prev"], sh_coeffs=None)
        st, traced = probes.trace_probes(scene, isect, depth, normal, o, d, r["probe_dir"], r["probe_mip"], prev,
                                         settings, frame_index, cut_blend(frame_index), occl,
                                         include_direct=not hybrid, return_count=True)
        out = {"probe_atlas": st.atlas, "probe_depth": st.depth}
        if hybrid:
            # The per-pixel NEE shades with the whole surface.
            surface = gbuffer_mod.unpack_surface(gbuffer_mod.PackedGBuffer(data=r["gbuf_data"], depth=depth), normal)
            out["direct"], n_direct = probes.hybrid_direct(scene, occl, surface, depth, o, d, settings, frame_index)
            traced = traced + n_direct
        # The G-buffer's primaries, then the probe rays and shadow lanes.
        out["rays_traced"] = r["rays_traced@prev"] + (h * w + traced)
        return out

    def sh(r, cam, frame_index):
        st = probes.ProbeState(atlas=r["probe_atlas"], depth=r["probe_depth"], sh_coeffs=None)
        return {"sh": probes.project_sh(st, settings).sh_coeffs}

    def interpolate(r, cam, frame_index):
        depth, normal, data = r["gbuf_depth"], r["gbuf_normal"], r["gbuf_data"]
        if not hybrid:
            return {"light": probes.interpolate_packed(depth, normal, data, r["sh"], settings)}
        indirect = probes.interpolate_packed(depth, normal, data, r["sh"], settings, emission=False)
        light, indirect = probes.hybrid_light(indirect, r["direct"], depth, packing.unpack_rgb9e5(data[..., 3]))
        # The per-pixel direct term is one NEE sample a frame: blend it with
        # the atlas's factor and cut, the indirect term is smoothed inside
        # the atlas already.
        prev_direct = r["direct_hist@prev"]
        direct = prev_direct + ((light - indirect) - prev_direct) * cut_blend(frame_index)
        return {"light": indirect + direct, "direct_hist": direct}

    def post(r, cam, frame_index):
        return {"display": postprocess.postprocess(r["light"])}

    gbuf = ["gbuf_data", "gbuf_depth", "gbuf_normal"]
    g.add_pass("gbuffer", gbuffer, writes=gbuf[:2])
    g.add_pass("sis", sis, reads=["gbuf_data"], writes=["gbuf_normal", "probe_dir", "probe_mip"])
    g.add_pass("probe_trace", probe_trace,
               reads=gbuf + ["probe_dir", "probe_mip", "probe_atlas@prev", "probe_depth@prev", "rays_traced@prev"],
               writes=["probe_atlas", "probe_depth", "rays_traced"] + (["direct"] if hybrid else []))
    g.add_pass("sh", sh, reads=["probe_atlas", "probe_depth"], writes=["sh"])
    g.add_pass("interpolate", interpolate, reads=["sh"] + gbuf + (["direct", "direct_hist@prev"] if hybrid else []),
               writes=["light"] + (["direct_hist"] if hybrid else []))
    g.add_pass("post", post, reads=["light"], writes=["display"])
    return _frame_step(g, jit), lambda: g.init_state(device)


def probe_gi_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, blendfactor: float = 0.15,
                      backend=None, *, device, jit: bool = True):
    """The probe pipeline (SURVEY.md §3.5): packed G-buffer (tile-ordered
    primaries through the backend's ``bind_primary``) → SIS → trace_probes
    → SH → interpolate → AgX."""
    return _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, False, jit)


def hybrid_gi_pipeline(scene, settings, intersect_fn=None, occluded_fn=None, blendfactor: float = 0.15,
                       backend=None, *, device, jit: bool = True):
    """Hybrid probes + path tracing (``probes.hybrid_gi_from_gbuffer``): the
    probe pipeline's shape with per-pixel direct NEE over an indirect-only
    atlas and a temporal ``direct_hist``."""
    return _probe_pipeline(scene, settings, intersect_fn, occluded_fn, blendfactor, backend, device, True, jit)
