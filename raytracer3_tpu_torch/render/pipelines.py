"""The progressive wavefront pipeline (port of ``wavefront_pipeline`` from
``raytracer3_tpu/render/pipelines.py``) as a plain composition: trace →
progressive blend → AgX. The reference's frame graph, the denoiser and the
other pipelines are later slices."""

from __future__ import annotations

import torch

from raytracer3_tpu_torch.render import postprocess, wavefront


def wavefront_pipeline(scene, settings, intersect_fn=None, occluded_fn=None,
                       sort_rays: bool = True, backend=None, blue_noise=None, *, device):
    """Returns ``(step, init_state)``; ``step(state, cam, frame_index) ->
    (display, state)`` renders one frame and folds it into the film with
    weight 1/(n+1). Pass ``backend=`` (a TraceBackend) or the two trace
    functions."""
    device = torch.device(device)
    w, h = settings.width, settings.height
    if backend is not None:
        intersect_fn, occluded_fn = backend.bind(backend.arrays)

    def init_state():
        return {
            "film": torch.zeros((h, w, 3), dtype=torch.float32, device=device),
            "frame_count": torch.zeros((), dtype=torch.float32, device=device),
        }

    def step(state, cam, frame_index):
        radiance = wavefront.render_frame(
            scene, cam, settings, frame_index, intersect_fn, occluded_fn,
            sort_rays=sort_rays, blue_noise=blue_noise,
        )
        n = state["frame_count"]
        t = 1.0 / (n + 1.0)
        film = state["film"] + (radiance - state["film"]) * t
        return postprocess.postprocess(film), {"film": film, "frame_count": n + 1.0}

    return step, init_state
