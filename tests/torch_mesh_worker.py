"""One rank of a gloo group that runs every ``parallel/mesh`` case of
``tests/test_torch_parallel_mesh.py`` on the CPU, and writes what it got to
``<out>/rank<r>.npz``. It imports torch and the port only.

    python tests/torch_mesh_worker.py --rank R --world N --init file:///tmp/pg --out DIR
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracer3_tpu_torch.utils.config import RenderSettings  # noqa: E402

# The cases' settings, shared with the test module.
TILED = RenderSettings(width=16, height=32, bounces=2, samples=1, diffuse_only=True)
# The reference's 8-device mesh compiles its frame in ~40 s at this size.
TILED_SMALL = RenderSettings(width=16, height=8, bounces=1, samples=1, diffuse_only=True)
WAVEFRONT = RenderSettings(width=16, height=8, bounces=1, samples=1, diffuse_only=True)
STATS = RenderSettings(width=16, height=16, bounces=2, samples=1)
PROBE = RenderSettings(width=32, height=32, bounces=1, samples=1, probe_spacing=8, probe_res=4, diffuse_only=True)


def cornell():
    """(scene, camera, isect, occl, TraceBackend) of the Cornell box on the
    CPU with the brute-force backend."""
    from raytracer3_tpu_torch.ops import intersect
    from raytracer3_tpu_torch.scene import analytic

    scene = analytic.cornell_box(device="cpu")
    b = intersect.brute_backend(scene=scene, device="cpu")
    isect, occl = b.bind(b.arrays)
    return scene, analytic.default_camera(device="cpu"), isect, occl, b


def backends(scene):
    """The packet (K1/K2's plain version on the CPU) and treelet (K3's)
    backends over the scene."""
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.ops import treelets

    tris = tuple(t.numpy() for t in scene.tri_vertices())
    return {
        "packet": tk.packet_backend(host_tris=tris, device="cpu"),
        "treelet": treelets.treelet_backend(host_tris=tris, leaf_size=4, width=8, max_tris=16, sublanes=8,
                                            device="cpu"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    # One thread: the CPU build of torch can return one low-accuracy chunk
    # from its first multi-threaded torch.sqrt (ROADMAP.md Queue 3).
    torch.set_num_threads(1)

    from raytracer3_tpu_torch.parallel import mesh as pmesh
    from raytracer3_tpu_torch.utils import runtime

    runtime.init_distributed(args.init, args.world, args.rank, device="cpu", timeout_s=120.0)
    try:
        mesh = pmesh.make_render_mesh()
        scene, cam, isect, occl, brute = cornell()
        out = {"tiled": pmesh.render_tiled(scene, cam, TILED, 0, isect, occl, mesh=mesh),
               "tiled_small": pmesh.render_tiled(scene, cam, TILED_SMALL, 0, isect, occl, mesh=mesh)}
        step, init_film = pmesh.progressive_step_tiled(scene, cam, TILED, isect, occl, mesh=mesh)
        film = init_film()
        for fi in (0, 1):
            film = step(film, fi)
        out["film"] = film.accum
        out["film_count"] = torch.tensor(film.frame_index)
        out["sample"] = pmesh.render_sample_parallel(scene, cam, TILED, 3, isect, occl, mesh=mesh)
        for name, b in backends(scene).items():
            out[name] = pmesh.render_wavefront_tiled(scene, cam, WAVEFRONT, 3, b.arrays, b.intersect_fn,
                                                     b.occluded_fn, mesh=mesh)
        b = backends(scene)["packet"]
        out["stats"], out["stats_counts"] = pmesh.render_wavefront_tiled(
            scene, cam, STATS, 0, b.arrays, b.intersect_fn, b.occluded_fn, mesh=mesh, sort_rays=True,
            return_stats=True)
        out["probe"] = pmesh.probe_gi_sample_parallel(scene, PROBE, cam, brute, n_frames=2, mesh=mesh)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "raytracer3_tpu"))
        assert not bad, f"a rank loaded {bad}"
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **{k: v.numpy() for k, v in out.items()})
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
