"""The system under test, driven as a user drives it: the scene built as a
``World`` of ``raytracer3_tpu_torch``, its trace backend, the frame
function of the configuration's frame path (``frames/<name>.py``; the
wavefront path's is the viewer's default progressive frame,
``make_default_frame_fn`` over ``render/pipelines.wavefront_pipeline``'s
compiled step: one CUDA graph a frame on the card) and an
``app/viewer.Viewer`` with the configuration's frames in flight, stepped
in a closed loop with the traffic's controls.

Of the program the benchmark takes only this path, its kernels' names and
the frame function's own traced-ray count (``Viewer.rays_traced()``)."""

from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch


def build_world(config: dict, mesh: dict, sky: np.ndarray):
    """The configuration's scene as a ``World``: ``ingest`` "glb" writes the
    mesh as a GLB into the asset cache's directory (once per checkout) and
    loads it through the processed-asset cache, as a user's GLB comes in;
    "direct" registers the arrays, as ``viewer.atrium_world`` does."""
    from raytracer3_tpu_torch.app import world as world_mod
    from raytracer3_tpu_torch.scene import assets
    from raytracer3_tpu_torch.scene import gltf as gltf_mod

    w = world_mod.World()
    if config["scene"]["ingest"] == "glb":
        path = os.path.join(assets._cache_dir(None), f"rtbench_{config['name']}.glb")
        if not os.path.exists(path):
            data = gltf_mod.write_glb_multi(None, mesh["positions"], mesh["normals"], mesh["uvs"], mesh["indices"],
                                            mesh["geo_id"], mesh["base_color"], mesh["emission"], mesh["metallic"],
                                            mesh["roughness"])
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        w.spawn(w.add_mesh_data(assets.load_glb_cached(path)), name=config["name"])
    else:
        for i in range(len(mesh["base_color"])):
            w.add_material(mesh["base_color"][i], mesh["emission"][i], mesh["metallic"][i], mesh["roughness"][i])
        w.spawn(w.add_mesh(mesh["positions"], mesh["normals"], mesh["uvs"], mesh["indices"], mesh["geo_id"]),
                name=config["name"])
    w.env_map = sky
    return w


def render_settings(config: dict, traffic: dict):
    from raytracer3_tpu_torch.utils.config import RenderSettings

    r = config["render"]
    return RenderSettings(width=r["width"], height=r["height"], bounces=r["bounces"], samples=traffic["samples"],
                          sample_batch=traffic["sample_batch"], lane_diet=traffic["lane_diet"],
                          radiance_clamp=r["radiance_clamp"])


class Program:
    """The port's scene, backend and frame function for one cell, the
    frame function built by the frame path ``frame`` (a module of
    ``frames/``); viewers made from it share the frame function, so its
    graph is captured once. A frame function that counts no traced rays
    is refused here."""

    def __init__(self, config: dict, traffic: dict, mesh: dict, sky: np.ndarray, blue_noise: np.ndarray, device,
                 frame, frame_wrapper=None):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.world = build_world(config, mesh, sky)
        self.scene = self.world.scene(device=self.device)
        self.backend = self.world.trace_backend(config["backend"], device=self.device)
        self.settings = render_settings(config, traffic)
        self.blue_noise = torch.as_tensor(blue_noise, dtype=torch.float32, device=self.device)
        self.frame_fn = frame.frame_fn(self)
        if getattr(self.frame_fn, "rays_traced", None) is None:
            raise RuntimeError(f"frame path {frame.__file__}: its frame function counts no traced rays "
                               "(no rays_traced()), which traverse_roofline_pct reads")
        if frame_wrapper is not None:
            self.frame_fn = frame_wrapper(self.frame_fn, self)

    def camera(self, position, direction):
        from raytracer3_tpu_torch.render.camera import Camera

        r = self.config["render"]
        return Camera.create(position=tuple(position), direction=tuple(direction), fov_y_deg=r["fov_y_deg"],
                             aspect=r["width"] / r["height"], device=self.device)

    def viewer(self, schedule):
        from raytracer3_tpu_torch.app.viewer import Viewer

        return Viewer(self.frame_fn, self.camera(schedule.start_position, schedule.start_direction), self.settings,
                      frames_in_flight=int(self.config["frames_in_flight"]), device=self.device)


@dataclasses.dataclass
class Record:
    """What a window leaves for the metrics and the check."""

    t0: float
    t_end: float
    base_index: int  # the viewer's frame index of the window's first frame
    call: list  # host time of each frame's Viewer.step call
    done: list  # host time its display was seen done
    gathered: list  # window frame numbers whose pixels were gathered
    films: list  # [P, 3] colour state at the sampled pixels after each gathered frame
    displays: list  # [P, 3] display at the sampled pixels
    stretch: dict | None  # the traced stretch: cams, frame indices, traced rays, profile


def _apply(viewer, ctl):
    c = viewer.controls
    c.move_x, c.move_y, c.move_z, c.look_dx, c.look_dy = ctl


def warm_up(viewer, schedule, steps: int = 2) -> int:
    """The cell's one graph captured (the first step) and one warm frame
    replayed, at the start pose; then every frame done and the film reset,
    as the viewer's ``reset`` command does. Returns the steps taken."""
    from raytracer3_tpu_torch.render import film as film_mod

    for _ in range(steps):
        _apply(viewer, (0.0, 0.0, 0.0, 0.0, 0.0))
        viewer.step(dt=schedule.dt)
    viewer.drain()
    _sync(viewer.device)
    viewer.film = film_mod.reset(viewer.film)
    return steps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Done:
    """Marks each frame's display done: a CUDA event recorded after its
    step, polled after every step (on the CPU a frame is done when its step
    returns)."""

    def __init__(self, dev, done: list):
        self.dev, self.done = dev, done
        self.pending = collections.deque()

    def submitted(self, k: int):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.dev))
            self.pending.append((k, ev))
        else:
            self.done[k] = time.perf_counter()

    def poll(self, wait: bool = False):
        while self.pending:
            k, ev = self.pending[0]
            if wait:
                ev.synchronize()
            elif not ev.query():
                return
            self.done[k] = time.perf_counter()
            self.pending.popleft()


def run_window(viewer, schedule, seconds: float, pix: torch.Tensor, base_index: int, colour_state,
               stretch_frames: int = 0, profile_fn=None) -> Record:
    """Step the viewer in a closed loop for ``seconds``: each step applies
    the schedule's controls, calls ``Viewer.step`` and gathers the colour
    state (``colour_state(viewer)``, the frame path's) and the display at
    the sampled pixels ``pix``. With ``stretch_frames`` > 0 and
    ``profile_fn``, once a third of the window has passed and the camera
    stands still for the next ``stretch_frames`` frames, the frames in
    flight are drained and those frames run under ``profile_fn()`` (a
    context manager) with no gathers, then drained: a stretch of the
    steady frame, whose kernels repeat from seed to seed. The frame
    function's traced-ray count is read at the two drained points, outside
    the profiler; the stretch's ``rays`` is their difference."""
    dev = viewer.device
    call, done, gathered, films, displays = [], [], [], [], []
    marks = _Done(dev, done)
    stretch = None
    _sync(dev)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    k = 0

    def step(gather: bool):
        nonlocal k
        _apply(viewer, schedule.controls(k))
        call.append(time.perf_counter())
        done.append(None)
        disp = viewer.step(dt=schedule.dt)
        marks.submitted(k)
        if gather:
            gathered.append(k)
            displays.append(disp.reshape(-1, 3).index_select(0, pix))
            films.append(colour_state(viewer).reshape(-1, 3).index_select(0, pix))
        k += 1
        marks.poll()

    def still(k0: int) -> bool:
        return all(not any(abs(v) > 1e-9 for v in schedule.controls(k)) for k in range(k0, k0 + stretch_frames))

    while time.perf_counter() < t_end:
        if (stretch is None and stretch_frames and time.perf_counter() - t0 >= seconds / 3.0 and still(k)):
            viewer.drain()
            marks.poll(wait=True)
            rays0 = viewer.rays_traced()
            stretch = {"cams": [], "frame_indices": []}
            with profile_fn() as prof:
                with torch.profiler.record_function("rtbench:stretch"):
                    for _ in range(stretch_frames):
                        step(gather=False)
                        stretch["cams"].append(viewer.cam)
                        stretch["frame_indices"].append(viewer.frame_index - 1)
                    viewer.drain()
                    _sync(dev)
            marks.poll(wait=True)
            stretch["rays"] = viewer.rays_traced() - rays0
            stretch["profile"] = prof
            continue
        step(gather=True)
    viewer.drain()
    marks.poll(wait=True)
    return Record(t0=t0, t_end=t_end, base_index=base_index, call=call, done=done, gathered=gathered, films=films,
                  displays=displays, stretch=stretch)
