"""Interactive progressive viewer and offline render loop (port of
``raytracer3_tpu/app/viewer.py``).

The counterpart of the reference application loop: the Bevy App with camera
controls (src/main.rs:92-132, src/components/camera.rs:90-191) and the
progressive accumulate/reset behaviour of interactive path tracing
(BASELINE.json config 5). A render host has no window, so the "swapchain"
is a PNG or MJPEG sink (``app/preview.py``); input arrives as a line
protocol on stdin (``InteractiveSession``), and a camera move restarts the
accumulation, as the reference's blend factor does.

Frames in flight (swapchain.rs:8, render_graph/mod.rs:630-649): eager
PyTorch queues a frame's kernels on the current stream and returns, so a
``Viewer`` step records one CUDA event after the frame's display and keeps
at most ``frames_in_flight`` frames unfinished; past that it waits on the
oldest event. On the CPU a frame is finished when its call returns.

Under a profiler, a step is the span ``viewer:step`` (its args the frame
index), the frame function's call into the device ``graph:run`` inside it
(``graph.capture_step``) and a wait on a frame ``viewer:wait``, inside the
step or, from ``drain``, outside it (``utils/profiling.span``: free when no
profiler is on).

    python -m raytracer3_tpu_torch.app.viewer --width 960 --height 544 [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import sys
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.app import preview as preview_mod
from raytracer3_tpu_torch.app import tuner as tuner_mod
from raytracer3_tpu_torch.app import world as world_mod
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import film as film_mod
from raytracer3_tpu_torch.render import pipelines
from raytracer3_tpu_torch.scene import assets, procedural
from raytracer3_tpu_torch.utils import image as image_io
from raytracer3_tpu_torch.utils import profiling
from raytracer3_tpu_torch.utils.config import RenderSettings

MOVE_SPEED = camera_mod.MOVE_SPEED  # camera.rs:18
ROTATE_SPEED = 1.0  # camera.rs:19 (radians per unit of accumulated mouse)
FPS_FRAMES = 60  # finished frames Viewer.fps looks back over
_clock = time.perf_counter  # the clock of a frame's finish


@dataclasses.dataclass
class Controls:
    """Input state, the Controls resource analog (camera.rs:61-88)."""

    move_x: float = 0.0  # A/D
    move_y: float = 0.0  # Shift/Space
    move_z: float = 0.0  # S/W
    look_dx: float = 0.0  # mouse delta (RMB held)
    look_dy: float = 0.0

    def consume(self):
        d = (self.look_dx, self.look_dy)
        self.look_dx = 0.0
        self.look_dy = 0.0
        return d

    @property
    def moving(self) -> bool:
        return any(
            abs(v) > 1e-9
            for v in (self.move_x, self.move_y, self.move_z, self.look_dx, self.look_dy)
        )


class Viewer:
    """Progressive renderer with camera control and accumulation reset.

    ``frame_fn(film, cam, frame_index) -> (film, display)`` renders one
    frame; ``frame_index`` counts every frame the viewer submitted, the film
    counts the frames since the last reset. A frame function that counts
    its traced rays carries ``rays_traced()`` (``make_default_frame_fn``)."""

    def __init__(self, frame_fn: Callable, cam: camera_mod.Camera, settings: RenderSettings,
                 frames_in_flight: int = 3, preview=None, *, device):
        self.frame_fn = frame_fn
        self.cam = cam
        self.settings = settings
        self.device = torch.device(device)
        self.controls = Controls()
        self.film = film_mod.Film.create(settings.height, settings.width, device=self.device)
        self.frame_index = 0
        self.frames_in_flight = frames_in_flight
        self.preview = preview  # a started app.preview.PreviewServer, or None
        self._inflight: deque = deque()  # (display, CUDA event or None)
        self._finished: deque = deque(maxlen=FPS_FRAMES)  # finish times, seconds
        self._last_display = None

    def update_camera(self, dt: float) -> bool:
        """editor_camera analog (camera.rs:127-178). Returns True if moved."""
        c = self.controls
        if not c.moving:
            return False
        yaw, pitch = c.consume()
        self.cam = camera_mod.orbit_camera(
            self.cam, -yaw * ROTATE_SPEED, -pitch * ROTATE_SPEED, (c.move_x, c.move_y, c.move_z), dt)
        return True

    def step(self, dt: float = 1 / 60):
        """One frame: input → (maybe) reset accumulation → submit."""
        with profiling.span("viewer:step", self.frame_index):
            if self.update_camera(dt):
                # A moving camera restarts the integral (config 5 behaviour).
                self.film = film_mod.reset(self.film)
            self.film, display = self.frame_fn(self.film, self.cam, self.frame_index)
            self.frame_index += 1
            event = None
            if display.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(display.device))
            self._inflight.append((display, event))
            while len(self._inflight) > self.frames_in_flight:
                self._finish(*self._inflight.popleft())
            return display

    def _finish(self, disp, event):
        """Wait for one submitted frame and record when it finished."""
        with profiling.span("viewer:wait"):
            if event is not None:
                event.synchronize()
        self._finished.append(_clock())
        self._last_display = disp
        self._maybe_publish(disp)

    def _maybe_publish(self, disp):
        """Push a finished frame to the MJPEG preview only when a client is
        connected and the rate limiter allows: an unattended render never
        copies a display to the host."""
        if self.preview is not None and self.preview.wants_frame():
            self.preview.publish(disp)

    def drain(self):
        """Wait for every frame in flight; returns the newest display (the
        last drained, or the last finished before: a second drain with
        nothing in flight must not lose the frame for ``save``)."""
        while self._inflight:
            self._finish(*self._inflight.popleft())
        return self._last_display

    @property
    def fps(self) -> float:
        """Frames finished a second over the last ``FPS_FRAMES`` finished:
        their count less one over the time from the first to the last (0
        before two)."""
        if len(self._finished) < 2 or self._finished[-1] <= self._finished[0]:
            return 0.0
        return (len(self._finished) - 1) / (self._finished[-1] - self._finished[0])

    def rays_traced(self):
        """Rays the frame function traced since it was made (the film's
        resets do not clear it), read from the device with one copy, which
        waits for the frames in flight; None for a frame function that does
        not count them."""
        count = getattr(self.frame_fn, "rays_traced", None)
        return None if count is None else int(count())


def make_default_frame_fn(scene, settings: RenderSettings, intersect_fn=None, occluded_fn=None,
                          backend=None, denoise: bool = False, *, blue_noise=None):
    """Standard progressive frame: wavefront path tracing → film blend →
    AgX display, as ``(film, cam, frame_index) -> (film, display)``.

    The frame is ``render/pipelines.wavefront_pipeline``'s step on the
    film's accumulation and count, compiled as the reference jits its
    frame: on a CUDA device one CUDA graph replayed a frame, the film's
    accumulation its donated state (each display a fresh tensor, so frames
    in flight keep theirs). With ``backend=`` (a TraceBackend) the
    rays are coherence-sorted unless the backend sorts them itself.
    ``denoise=True`` shows shallow accumulations through the edge-aware
    à-trous filter (``render/denoise.py``): frames right after a camera
    move display smooth instead of as raw 1-spp noise.

    The frame carries the pipeline's ``rays_traced`` from frame to frame
    (on the device, one add a frame); ``frame.rays_traced()`` returns it as
    a 0-d int64 tensor."""
    device = scene.positions.device
    step, _ = pipelines.wavefront_pipeline(
        scene, settings, intersect_fn, occluded_fn,
        sort_rays=backend is not None and not backend.self_sorting,
        backend=backend, blue_noise=blue_noise, denoise=denoise, device=device)
    rays = [torch.zeros((), dtype=torch.int64, device=device)]

    def frame(film, cam, frame_index):
        state = {"film": film.accum,
                 "frame_count": torch.full((), float(film.frame_index), dtype=torch.float32, device=device),
                 "rays_traced": rays[0]}
        display, state = step(state, cam, frame_index)
        rays[0] = state["rays_traced"]
        return film_mod.Film(accum=state["film"], frame_index=film.frame_index + 1), display

    frame.rays_traced = lambda: rays[0]
    return frame


def make_probe_frame_fn(scene, settings: RenderSettings, backend=None, blendfactor: float = 0.15):
    """The real-time probe-GI frame (the reference's ``shaders/old/`` probe
    stack) as ``(film, cam, frame_index) -> (film, display)``:
    ``render/pipelines.probe_gi_pipeline``'s step through ``backend``: one
    CUDA graph a frame on the card. The probe atlas is the frame
    function's own state.

    The pipeline's frame index is the film's count, not the viewer's: the
    viewer resets the film when the camera moves, so a moved frame is a
    camera cut (blend factor 1, the atlas's history dropped) and the
    probes converge again from the stop. The film's accumulation carries
    the frame's lit image before AgX (the pipeline's ``light``). The frame
    carries ``rays_traced()`` as ``make_default_frame_fn`` does: the
    G-buffer's primaries, the probe rays and the shadow lanes, summed on
    the device."""
    device = scene.positions.device
    step, init_state = pipelines.probe_gi_pipeline(scene, settings, blendfactor=blendfactor, backend=backend,
                                                   device=device)
    cell = {"state": init_state()}

    def frame(film, cam, frame_index):
        display, cell["state"] = step(dict(cell["state"], light=film.accum), cam, film.frame_index)
        return film_mod.Film(accum=cell["state"]["light"], frame_index=film.frame_index + 1), display

    frame.rays_traced = lambda: cell["state"]["rays_traced"]
    return frame


class InteractiveSession:
    """Line-protocol interactive loop, the winit-event analog
    (src/components/camera.rs:90-125: RMB grab → mouse look, WASD keys).

    Commands (one per line on the input stream):

      move <x> <y> <z>     set continuous move state (A/D, Shift/Space, S/W)
      look <dx> <dy>       accumulate a mouse-look delta (radians-ish)
      stop                 zero the move state
      reset                reset film accumulation
      set <knob> <value>   change a RenderSettings knob via the tuner
                           (static knobs rebuild the frame function)
      preview [port]       start the MJPEG preview (needs PIL to encode)
      save <path>          write the current display to a PNG (needs PIL)
      stats                emit a JSON status line
      quit                 drain and exit

    A frame emits nothing; ``stats`` (and exit) emit a JSON line
    ``{"frame": n, "fps": f, "spp": n_accum}``.
    """

    def __init__(self, viewer: Viewer, rebuild=None):
        self.viewer = viewer
        self.rebuild = rebuild  # optional: (settings) -> new frame_fn
        self._pending = b""  # input read but not yet a whole line

    def status(self) -> dict:
        v = self.viewer
        return {"frame": v.frame_index, "fps": round(v.fps, 2), "spp": int(v.film.frame_index)}

    def handle(self, line: str) -> bool:
        """Apply one command; returns False on quit."""
        v = self.viewer
        parts = line.strip().split()
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        if cmd == "quit":
            return False
        elif cmd == "move":
            v.controls.move_x, v.controls.move_y, v.controls.move_z = (
                float(args[0]), float(args[1]), float(args[2]))
        elif cmd == "look":
            v.controls.look_dx += float(args[0])
            v.controls.look_dy += float(args[1])
        elif cmd == "stop":
            v.controls.move_x = v.controls.move_y = v.controls.move_z = 0.0
        elif cmd == "reset":
            v.film = film_mod.reset(v.film)
        elif cmd == "set" and self.rebuild is not None:
            knobs = tuner_mod.SettingsTuner(v.settings)
            new_settings, _ = knobs.apply(" ".join(args))
            if knobs.consume_recompile_flag():
                v.settings = new_settings
                v.frame_fn = self.rebuild(v.settings)
                v.film = film_mod.Film.create(v.settings.height, v.settings.width, device=v.device)
                v.frame_index = 0
        elif cmd == "preview":
            if v.preview is None:
                port = int(args[0]) if args else 8787
                v.preview = preview_mod.PreviewServer(port=port).start()
            print(json.dumps({"preview_port": v.preview.port}), flush=True)
        elif cmd == "save":
            disp = v.drain()
            if disp is not None:
                image_io.write_png(args[0], disp.detach().cpu().numpy())
        elif cmd == "stats":
            print(json.dumps(self.status()), flush=True)
        return True

    def run(self, stream=None, max_frames: Optional[int] = None):
        """Pump frames, applying commands as they arrive (non-blocking).

        The loop polls the stream's descriptor with ``select`` and reads
        what is there itself: a buffered ``readline`` would take a burst of
        lines into its buffer, where ``select`` no longer sees them.
        End of input acts as ``quit``."""
        fd = (stream if stream is not None else sys.stdin).fileno()
        last = time.perf_counter()
        while max_frames is None or self.viewer.frame_index < max_frames:
            if not self._apply_pending(fd):
                self.viewer.drain()
                print(json.dumps(self.status()), flush=True)
                return
            now = time.perf_counter()
            self.viewer.step(dt=now - last)
            last = now
        self.viewer.drain()
        print(json.dumps(self.status()), flush=True)

    def _apply_pending(self, fd: int) -> bool:
        """Apply every complete line waiting on ``fd``; False on quit or at
        the end of input."""
        while select.select([fd], [], [], 0)[0]:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                return False
            *lines, self._pending = (self._pending + chunk).split(b"\n")
            for line in lines:
                if not self.handle(line.decode()):
                    return False
        return True


def atrium_world(detail: int = 2, glb: Optional[str] = None):
    """The viewer's scene as a ``World``: the procedural atrium with the
    256×512 sky, or a GLB through the processed-asset cache."""
    w = world_mod.World()
    if glb:
        w.spawn(w.add_mesh_data(assets.load_glb_cached(glb)), name="glb")
        return w
    kw = procedural.atrium(detail=detail)
    for i in range(len(kw["base_color"])):
        w.add_material(kw["base_color"][i], kw["emission"][i], kw["metallic"][i], kw["roughness"][i])
    w.spawn(w.add_mesh(kw["positions"], kw["normals"], kw["uvs"], kw["indices"], kw["geo_id"]), name="atrium")
    w.env_map = procedural.sky_equirect(256, 512)
    return w


def main_settings(width: int, height: int, bounces: int) -> RenderSettings:
    """The viewer's render settings: 1 sample a frame, radiance clamp 50."""
    return RenderSettings(width=width, height=height, bounces=bounces, samples=1, radiance_clamp=50.0)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Interactive progressive viewer")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--detail", type=int, default=2)
    ap.add_argument("--glb", type=str, default=None, help="render a GLB scene")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--backend", type=str, default="auto")
    ap.add_argument("--preview-port", type=int, default=None,
                    help="serve a live MJPEG preview on this port (0 = auto-pick)")
    ap.add_argument("--denoise", action="store_true",
                    help="edge-aware a-trous filter on shallow-accumulation frames")
    ap.add_argument("--device", type=str, default="cuda",
                    help="render device: cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("viewer: --device cuda needs a CUDA device and none is available (--device cpu "
                           "renders on the CPU)")
    w = atrium_world(args.detail, args.glb)
    scene = w.scene(device=device)
    backend = w.trace_backend(args.backend, device=device)
    cam = procedural.atrium_camera(aspect=args.width / args.height, device=device)
    settings = main_settings(args.width, args.height, args.bounces)

    def rebuild(s):
        return make_default_frame_fn(scene, s, backend=backend, denoise=args.denoise)

    preview = None
    if args.preview_port is not None:
        preview = preview_mod.PreviewServer(port=args.preview_port).start()
        print(f'{{"preview_port": {preview.port}}}', flush=True)
    viewer = Viewer(rebuild(settings), cam, settings, preview=preview, device=device)
    try:
        InteractiveSession(viewer, rebuild=rebuild).run(max_frames=args.frames)
    finally:
        if viewer.preview is not None:
            viewer.preview.stop()


def render_offline(scene, cam: camera_mod.Camera, settings: RenderSettings, intersect_fn, occluded_fn=None,
                   n_frames: int = 64, out_path: Optional[str] = None,
                   camera_path: Optional[Callable[[int], camera_mod.Camera]] = None) -> np.ndarray:
    """Offline progressive render on the scene's device (optionally along an
    animated camera path, each new camera resetting the accumulation);
    returns the final display image as numpy."""
    frame = make_default_frame_fn(scene, settings, intersect_fn, occluded_fn)
    viewer = Viewer(frame, cam, settings, device=scene.positions.device)
    for i in range(n_frames):
        if camera_path is not None:
            new_cam = camera_path(i)
            if new_cam is not None:
                viewer.cam = new_cam
                viewer.film = film_mod.reset(viewer.film)
        viewer.step()
    img = viewer.drain().detach().cpu().numpy()
    if out_path:
        image_io.write_png(out_path, img)
    return img


if __name__ == "__main__":
    main()
