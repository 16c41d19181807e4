"""Multi-device rendering on ``torch.distributed`` (port of
``raytracer3_tpu/parallel/mesh.py``, whose ``shard_map`` bodies run here
once per rank).

- **Row (tile) parallelism**: the image rows are split over the ranks of
  the mesh; each rank builds its rays from their global pixel ids, so the
  per-pixel RNG is the single-device frame's, traces against replicated
  scene and tables, and ``all_gather`` reassembles the image.
- **Sample parallelism**: each rank renders the whole image with the frame
  seed ``frame · n + rank``; ``all_reduce(SUM) / n`` averages the estimates.

The mesh is a 1-D ``DeviceMesh`` over the default process group
(``utils/runtime.init_distributed``): NCCL on CUDA, one card per rank; gloo
on the CPU. Every function returns the same tensor on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from raytracer3_tpu_torch.ops import rng
from raytracer3_tpu_torch.render import camera as camera_mod
from raytracer3_tpu_torch.render import film as film_mod
from raytracer3_tpu_torch.render import pathtracer
from raytracer3_tpu_torch.scene import types as scene_types

_M32 = 0xFFFFFFFF


def make_render_mesh(device_type: str | None = None, axis: str = "tiles"):
    """1-D render mesh over every rank of the default process group;
    ``device_type`` defaults to the group's (cuda under NCCL, else cpu)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh: no process group (call utils/runtime.init_distributed first)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _group(mesh, axis: str):
    """(process group, this rank on the axis, ranks on the axis)."""
    mesh = mesh if mesh is not None else make_render_mesh(axis=axis)
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _row_pixels(settings, rank: int, n: int, device) -> torch.Tensor:
    """Global pixel coords [hs·W, 2] of this rank's block of hs = H/n rows."""
    w, h = settings.width, settings.height
    if h % n:
        raise ValueError(f"height {h} must divide across {n} ranks")
    hs = h // n
    return camera_mod.pixel_grid(w, h, device=device)[rank * hs * w:(rank + 1) * hs * w]


def _gather_rows(rows: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(parts, rows.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _render_rows(scene, cam, settings, frame_index, intersect_fn, occluded_fn, pix) -> torch.Tensor:
    """The reference's ``render_tiled`` shard body: reference-mode radiance
    of the given pixels → [rows, W, 3]."""
    w, h = settings.width, settings.height
    sampler = rng.Sampler.from_pixels(pix, frame_index)
    uj, sampler = sampler.next2()
    o, d = camera_mod.primary_rays(cam, w, h, jitter=uj, pixel_xy=pix)
    gbuf = pathtracer.trace_gbuffer(scene, intersect_fn, o, d)
    radiance = pathtracer.trace_radiance(scene, intersect_fn, o, d, gbuf, sampler, settings, occluded_fn)
    radiance = torch.where(gbuf.hit[:, None], radiance, pathtracer._sample_env(scene, d))
    return radiance.reshape(-1, w, 3)


def render_tiled(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                 intersect_fn, occluded_fn=None, mesh=None, axis: str = "tiles") -> torch.Tensor:
    """One reference-mode frame [H, W, 3] with the image rows split over the
    mesh: each rank traces its rows (no traffic while tracing), then the
    rows are gathered. Equal to the single-device frame bit for bit."""
    group, rank, n = _group(mesh, axis)
    pix = _row_pixels(settings, rank, n, scene.positions.device)
    rows = _render_rows(scene, cam, settings, frame_index, intersect_fn, occluded_fn, pix)
    return _gather_rows(rows, group, n)


def render_sample_parallel(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                           intersect_fn, occluded_fn=None, mesh=None, axis: str = "tiles") -> torch.Tensor:
    """Each rank renders the whole image at frame seed ``frame · n + rank``;
    the mean over ranks. Samples per frame = n × ``settings.samples``."""
    group, rank, n = _group(mesh, axis)
    fi = ((int(frame_index) & _M32) * n + rank) & _M32
    img = pathtracer.render_image(scene, cam, settings, fi, intersect_fn, occluded_fn)
    dist.all_reduce(img, op=dist.ReduceOp.SUM, group=group)
    return img / n


def progressive_step_tiled(scene: scene_types.Scene, cam: camera_mod.Camera, settings, intersect_fn,
                           occluded_fn=None, mesh=None, axis: str = "tiles") -> tuple[Callable, Callable]:
    """The per-frame step (render + film blend) with the film split by rows:
    each rank keeps and blends only its own [H/n, W, 3] rows. Returns
    ``(step(film, frame_index) -> film, init_film() -> film)``; gather the
    rows with ``all_gather`` to show the image."""
    _, rank, n = _group(mesh, axis)
    dev = scene.positions.device
    pix = _row_pixels(settings, rank, n, dev)

    def step(film: film_mod.Film, frame_index) -> film_mod.Film:
        rows = _render_rows(scene, cam, settings, frame_index, intersect_fn, occluded_fn, pix)
        return film_mod.accumulate_progressive(film, rows)

    def init_film() -> film_mod.Film:
        return film_mod.Film.create(settings.height // n, settings.width, device=dev)

    return step, init_film


def render_wavefront_tiled(scene: scene_types.Scene, cam: camera_mod.Camera, settings, frame_index,
                           backend_arrays, intersect_fn, occluded_fn=None, mesh=None, axis: str = "tiles",
                           sort_rays: bool = False, capped_fn=None, return_stats: bool = False):
    """The production wavefront with the image rows split over the mesh:
    each rank builds its queue from its rows' global pixel ids and traces
    through the backend it is given (K1/K2, K3 or K4 on the card) over the
    replicated tables; ``all_gather`` reassembles the image [H, W, 3].

    ``intersect_fn``/``occluded_fn`` follow the TraceBackend convention
    ``fn(arrays, o, d[, t_max])``; ``capped_fn`` with
    ``settings.fuse_shadow`` gives the fused shadow + bounce launch.
    ``return_stats=True`` also returns the traced-ray count of every rank
    (int64 [n]: primaries + alive closest-hit lanes + shadow lanes), the
    row split's load balance."""
    from raytracer3_tpu_torch.render import wavefront

    group, rank, n = _group(mesh, axis)
    w = settings.width
    dev = scene.positions.device
    p = _row_pixels(settings, rank, n, dev)
    m = p.shape[0]

    def isect(o, d):
        return intersect_fn(backend_arrays, o, d)

    occl = None if occluded_fn is None else (lambda o, d, t: occluded_fn(backend_arrays, o, d, t))
    fused = None
    if capped_fn is not None and settings.fuse_shadow:
        def fused(o, d, t, anyhit=None):
            return capped_fn(backend_arrays, o, d, t, anyhit)

    sampler = rng.Sampler.from_pixels(p, frame_index)
    uj, sampler = sampler.next2()
    o, d = camera_mod.primary_rays(cam, w, settings.height, jitter=uj, pixel_xy=p)
    hit0 = isect(o, d)
    q = wavefront.RayQueue(
        origin=o, direction=d,
        throughput=torch.ones((m, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((m, 3), dtype=torch.float32, device=dev),
        pixel_id=(p[:, 1] * w + p[:, 0]).to(torch.int32),
        alive=hit0.hit,
        prev_pdf=torch.full((m,), 1e8, dtype=torch.float32, device=dev),
        depth=hit0.t, prim_id=hit0.prim_id, uv=hit0.uv, inst=hit0.inst,
    )
    q, traced = wavefront.trace_wavefront(scene, isect, q, sampler, settings, occl, sort_rays, fused_fn=fused)
    radiance = q.radiance
    if settings.radiance_clamp > 0.0:
        radiance = torch.clamp_max(radiance, settings.radiance_clamp)
    radiance = radiance + torch.where(~hit0.hit[:, None], pathtracer._sample_env(scene, d), 0.0)
    img = _gather_rows(radiance.reshape(-1, w, 3), group, n)
    if not return_stats:
        return img
    counts = torch.as_tensor(traced, dtype=torch.int64, device=dev).reshape(1) + m
    return img, _gather_rows(counts, group, n)


def probe_gi_sample_parallel(scene: scene_types.Scene, settings, cam: camera_mod.Camera, backend,
                             n_frames: int = 2, mesh=None, axis: str = "tiles", pipeline: str = "probe"):
    """The probe-GI pipeline (``"probe"``) or the hybrid (``"hybrid"``)
    under sample parallelism: each rank runs the whole pipeline at frame
    seeds ``i · n + rank``; the displays of the last frame are averaged over
    ranks. (Probe interpolation reads neighbouring probes, so a row split
    would need halos.)"""
    from raytracer3_tpu_torch.render import pipelines

    group, rank, n = _group(mesh, axis)
    factory = pipelines.hybrid_gi_pipeline if pipeline == "hybrid" else pipelines.probe_gi_pipeline
    step, init_state = factory(scene, settings, backend=backend, device=scene.positions.device)
    state = init_state()
    disp = None
    for i in range(n_frames):
        disp, state = step(state, cam=cam, frame_index=(i * n + rank) & _M32)
    disp = disp.contiguous()
    dist.all_reduce(disp, op=dist.ReduceOp.SUM, group=group)
    return disp / n
