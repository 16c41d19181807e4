"""Interactive-mode evidence at the north star (port of
``tools/interactive_evidence.py``, BASELINE config 5): the real ``Viewer``
(frames in flight, camera controls, accumulation reset) over the probe-GI
pipeline on the 300k-triangle atrium (``procedural.sponza_world_scene(8)``,
K3 through ``packet_backend``) at 1920×1088 for ``--frames`` frames along a
scripted camera path, recording

- the per-frame trace (phase, wall time, step time, spp, fps) and a summary
  → ``interactive_trace.json``;
- a PNG strip (pre-move, during the move, +1, +5 and +20 frames after the
  stop, downscaled 2×) → ``<tag>.png``;
- the move → 90% converged latency (the probe blend 0.15 settles to 90%
  after ~14 frames: 14 × the steady frame time).

The pipeline rides the viewer through its film: the film's frame count
(reset to 0 by ``Viewer.step`` on a camera move) is the pipeline's
``frame_index``, so the first frame after a move blends the probes with
factor 1, the camera-cut path. Everything goes to ``--out``.

    python -m raytracer3_tpu_torch.tools.interactive_evidence [--frames 120] [--out build/interactive]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

DEFAULT_OUT = os.path.join("build", "interactive")
# Frame → strip tag: before the move, during it, and 1, 5 and 20 frames
# after the stop at frame 38.
SNAPS = {29: "pre_move", 34: "during_move", 39: "stop_plus1", 43: "stop_plus5", 58: "stop_plus20"}
MOVE_START, MOVE_STOP = 30, 38
TIMED_FRAMES = 20


def evidence(tris, step, init_state, cam, settings, frames: int = 120, out: str = DEFAULT_OUT, *, device):
    """Drive ``Viewer`` (3 frames in flight) over the pipeline ``(step,
    init_state)`` on a scene (``tris``: its host triangles, counted in the
    summary) along the scripted path, then ``TIMED_FRAMES`` still frames for
    the steady frame time; write the strip and the trace into ``out`` and return
    ``{"summary", "trace"}``."""
    from raytracer3_tpu_torch.app import viewer as viewer_mod
    from raytracer3_tpu_torch.render import film as film_mod
    from raytracer3_tpu_torch.utils import image as image_io

    dev = torch.device(device)
    w, h = settings.width, settings.height
    cell = {"st": init_state(), "finite": torch.ones((), dtype=torch.bool, device=dev)}

    def frame_fn(film, cam_, frame_index):
        # film.frame_index == 0 right after a motion reset: the pipeline
        # blends its probes with factor 1 (camera-cut invalidation).
        disp, cell["st"] = step(cell["st"], cam_, film.frame_index)
        cell["finite"] = cell["finite"] & disp.isfinite().all()
        return film_mod.Film(accum=film.accum, frame_index=film.frame_index + 1), disp

    viewer = viewer_mod.Viewer(frame_fn, cam, settings, frames_in_flight=3, device=dev)
    os.makedirs(out, exist_ok=True)

    def snap(tag):
        img = viewer.drain().detach().cpu().numpy()
        path = os.path.join(out, f"{tag}.png")
        image_io.write_png(path, img[::2, ::2])  # downscaled 2x
        print(f"  snap {tag} -> {path}", file=sys.stderr, flush=True)

    trace = []
    phase = "warmup"
    move_stop_frame = None
    t_start = time.perf_counter()
    for i in range(frames):
        # Scripted path: 30 still frames, 8 frames of a gentle pan and a
        # short dolly (inside the colonnade), then a stop and reconvergence.
        if i == MOVE_START:
            phase = "moving"
            viewer.controls.move_z = 0.3
            viewer.controls.look_dx = 0.06
        elif MOVE_START < i < MOVE_STOP:
            viewer.controls.look_dx = 0.06  # consumed every frame
        elif i == MOVE_STOP:
            phase = "reconverge"
            viewer.controls.move_z = 0.0
            viewer.controls.look_dx = 0.0
            move_stop_frame = i
        t0 = time.perf_counter()
        viewer.step(dt=1 / 30)
        trace.append(dict(frame=i, phase=phase, t=round(time.perf_counter() - t_start, 4),
                          step_ms=round((time.perf_counter() - t0) * 1e3, 2), spp=int(viewer.film.frame_index),
                          fps=round(viewer.fps, 3)))
        if i in SNAPS:
            snap(SNAPS[i])

    viewer.drain()
    # Steady frame time: a step only submits its frame, so the step times
    # above are submit latency. Time still frames chained through the state
    # with one wait at the end.
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        viewer.step(dt=1 / 30)
    viewer.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    frame_ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3
    summary = dict(
        width=w, height=h, tris=int(tris[0].shape[0]), frames=frames,
        total_s=round(time.perf_counter() - t_start, 1), steady_frame_ms=round(frame_ms, 1),
        fps=round(1e3 / frame_ms, 2), move_stop_frame=move_stop_frame,
        move_to_90pct_converged_s=round(14 * frame_ms / 1e3, 2), probe_texel_splits=settings.probe_texel_splits,
        all_displays_finite=bool(cell["finite"]),
        note="probe blend 0.15; 90% settled after ~14 frames; latency = 14 x the steady frame time",
    )
    trace_path = os.path.join(out, "interactive_trace.json")
    with open(trace_path, "w") as f:
        json.dump(dict(summary=summary, trace=trace), f, indent=1)
    print(f"wrote {trace_path}", file=sys.stderr, flush=True)
    return dict(summary=summary, trace=trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--splits", type=int, default=1)
    ap.add_argument("--out", default=DEFAULT_OUT, help="output directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: interactive evidence runs on the card")
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.render import pipelines
    from raytracer3_tpu_torch.scene import procedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    w, h = args.width, args.height
    scene, tris = procedural.sponza_world_scene(8, device=dev)
    cam = procedural.atrium_camera(aspect=w / h, device=dev)
    backend = tk.packet_backend(host_tris=tris, device=dev)
    settings = RenderSettings(width=w, height=h, bounces=1, samples=1, probe_texel_splits=args.splits)
    step, init_state = pipelines.probe_gi_pipeline(scene, settings, backend=backend, device=dev)
    out = evidence(tris, step, init_state, cam, settings, args.frames, args.out, device=dev)
    print(json.dumps(out["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
