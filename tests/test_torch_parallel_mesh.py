"""The port's multi-device rendering (``raytracer3_tpu_torch/parallel/
mesh.py``) on gloo process groups of 2 and 4 CPU processes, mirroring
tests/test_parallel_mesh.py's seven cases.

Each group is one run of ``tests/torch_mesh_worker.py`` per rank (torch and
the port only; rendezvous through a file under ``tmp_path``, so parallel
test workers cannot collide on a port; 120 s for the group to form, 300 s
for the run). The single-device frames are rendered here with the port:
- row splits are bit-equal to the single-device frame: ``render_tiled``
  (reference mode, Cornell 16×32, 2 bounces), ``render_wavefront_tiled``
  through the packet (K1/K2's plain version) and treelet (K3's) backends,
  and the row-split film of ``progressive_step_tiled``;
- sample parallelism equals the mean over the seeds ``frame · n + rank`` at
  rtol 1e-6 + atol 1e-7 (gloo sums in its own order);
- the per-rank traced-ray counts add up to the single-device frame's;
- ``render_tiled`` matches the reference's ``render_tiled`` on its 8-device
  virtual CPU mesh (tests/conftest.py) by test_torch_pathtracer.py's rule
  for ``render_image``: ≥ 99.5% of pixels within 1e-4.
~60 s alone, ~40 s of it the reference's mesh compile.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from raytracer3_tpu_torch.render import film as tfilm
from raytracer3_tpu_torch.render import pathtracer as tpathtracer
from raytracer3_tpu_torch.render import pipelines as tpipelines
from raytracer3_tpu_torch.render import wavefront as twavefront
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)


def _run_group(n: int, d) -> list:
    """Start n ranks, wait for all, return each rank's outputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"), "--rank",
                               str(r), "--world", str(n), "--init", f"file://{d}/pg", "--out", str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n{logs[r][-3000:] if r < len(logs) else ''}"
    return [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each group size's run: {n: [rank outputs]}."""
    return {n: _run_group(n, tmp_path_factory.mktemp(f"pg{n}")) for n in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda n: f"{n}ranks")
def group(request, groups):
    return request.param, groups[request.param]


@pytest.fixture(scope="module")
def single():
    """The single-device side, rendered in this process."""
    scene, cam, isect, occl, brute = worker.cornell()
    return scene, cam, isect, occl, brute, worker.backends(scene)


def _every_rank(outs, key):
    """The output every rank returned (all must be equal)."""
    for r in range(1, len(outs)):
        np.testing.assert_array_equal(outs[r][key], outs[0][key], err_msg=f"rank {r}")
    return outs[0][key]


def test_render_tiled_matches_single_device(group, single):
    n, outs = group
    scene, cam, isect, occl, _, _ = single
    ref = tpathtracer.render_image(scene, cam, worker.TILED, 0, isect, occl).numpy()
    # Per-pixel RNG keyed on global pixel ids: the row split changes no sample.
    np.testing.assert_array_equal(_every_rank(outs, "tiled"), ref)


def test_output_is_row_split(group):
    n, outs = group
    s = worker.TILED
    for r in range(n):
        assert outs[r]["film"].shape == (s.height // n, s.width, 3)
    gathered = np.concatenate([outs[r]["film"] for r in range(n)])
    assert gathered.shape == (s.height, s.width, 3) and np.isfinite(gathered).all() and gathered.mean() > 0.01


def test_sample_parallel_equals_seed_mean(group, single):
    n, outs = group
    scene, cam, isect, occl, _, _ = single
    frames = [tpathtracer.render_image(scene, cam, worker.TILED, 3 * n + i, isect, occl) for i in range(n)]
    ref = torch.stack(frames).mean(dim=0).numpy()
    np.testing.assert_allclose(_every_rank(outs, "sample"), ref, rtol=1e-6, atol=1e-7)


def test_progressive_step_tiled_keeps_its_rows(group, single):
    n, outs = group
    scene, cam, isect, occl, _, _ = single
    s = worker.TILED
    film = tfilm.Film.create(s.height, s.width, device="cpu")
    for fi in (0, 1):
        film = tfilm.accumulate_progressive(film, tpathtracer.render_image(scene, cam, s, fi, isect, occl))
    hs = s.height // n
    for r in range(n):
        assert int(outs[r]["film_count"]) == 2
        np.testing.assert_array_equal(outs[r]["film"], film.accum[r * hs:(r + 1) * hs].numpy(), err_msg=f"rank {r}")


@pytest.mark.parametrize("kind", ["packet", "treelet"])
def test_wavefront_tiled_through_a_backend_matches_single(group, single, kind):
    n, outs = group
    scene, cam, _, _, _, backends = single
    b = backends[kind]
    isect, occl = b.bind(b.arrays)
    ref = twavefront.render_frame(scene, cam, worker.WAVEFRONT, 3, isect, occl).numpy()
    got = _every_rank(outs, kind)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_multiprocess_traced_counts(group, single):
    # tests/test_parallel_mesh.py's multi-process run: the production
    # wavefront over n processes equals the one-process frame, and the
    # per-rank traced-ray counts add up to its count.
    n, outs = group
    scene, cam, _, _, _, backends = single
    b = backends["packet"]
    isect, occl = b.bind(b.arrays)
    ref, traced = twavefront.render_frame(scene, cam, worker.STATS, 0, isect, occl, sort_rays=True,
                                          return_stats=True)
    np.testing.assert_array_equal(_every_rank(outs, "stats"), ref.numpy())
    counts = _every_rank(outs, "stats_counts")
    assert counts.shape == (n,) and counts.sum() == int(traced)
    assert counts.min() >= worker.STATS.width * worker.STATS.height // n  # each rank traced its primaries


def test_probe_gi_sample_parallel(group, single):
    n, outs = group
    scene, cam, _, _, brute, _ = single
    displays = []
    for r in range(n):
        step, init_state = tpipelines.probe_gi_pipeline(scene, worker.PROBE, backend=brute, device="cpu")
        state = init_state()
        for i in range(2):
            disp, state = step(state, cam=cam, frame_index=i * n + r)
        displays.append(disp)
    ref = torch.stack(displays).mean(dim=0).numpy()
    np.testing.assert_allclose(_every_rank(outs, "probe"), ref, rtol=1e-6, atol=1e-7)


def test_render_tiled_matches_the_reference_mesh(groups):
    import jax
    import jax.numpy as jnp

    from raytracer3_tpu.ops import intersect as jintersect
    from raytracer3_tpu.parallel import mesh as jmesh
    from raytracer3_tpu.scene import analytic as janalytic
    from raytracer3_tpu.utils.config import RenderSettings as JSettings

    s = worker.TILED_SMALL
    scene = janalytic.cornell_box()
    v0, v1, v2 = scene.tri_vertices()
    ref = jmesh.render_tiled(
        scene, janalytic.default_camera(),
        JSettings(width=s.width, height=s.height, bounces=s.bounces, samples=s.samples, diffuse_only=True),
        jnp.uint32(0), lambda o, d: jintersect.intersect_bruteforce(o, d, v0, v1, v2),
        lambda o, d, t: jintersect.occluded_bruteforce(o, d, v0, v1, v2, t_max=t),
        mesh=jmesh.make_render_mesh(jax.devices()))
    ref = np.asarray(ref)
    for n, outs in groups.items():
        got = _every_rank(outs, "tiled_small")
        assert got.shape == ref.shape and np.isfinite(got).all() and got.mean() > 0.01
        assert (np.abs(got - ref).max(-1) <= 1e-4).mean() >= 0.995, n


def test_init_distributed_needs_rank_and_size():
    from raytracer3_tpu_torch.utils import runtime

    with pytest.raises(ValueError, match="num_processes"):
        runtime.init_distributed("localhost:1", device="cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        runtime.init_distributed(device="meta")


@pytest.mark.gpu
def test_one_rank_nccl_wavefront_on_card(tmp_path):
    """A 1-rank NCCL group on the card: render_wavefront_tiled through
    K1/K2 bit-equal to render_frame's frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from raytracer3_tpu_torch.ops import traverse_kernel as tk
    from raytracer3_tpu_torch.parallel import mesh as pmesh
    from raytracer3_tpu_torch.scene import analytic
    from raytracer3_tpu_torch.utils import runtime

    scene = analytic.cornell_box(device="cuda")
    cam = analytic.default_camera(device="cuda")
    b = tk.packet_backend(host_tris=tuple(t.cpu().numpy() for t in scene.tri_vertices()), device="cuda")
    runtime.init_distributed(f"file://{tmp_path}/pg", 1, 0, device="cuda", timeout_s=60.0)
    try:
        got = pmesh.render_wavefront_tiled(scene, cam, worker.STATS, 0, b.arrays, b.intersect_fn, b.occluded_fn,
                                           mesh=pmesh.make_render_mesh(), sort_rays=True)
    finally:
        torch.distributed.destroy_process_group()
    isect, occl = b.bind(b.arrays)
    ref = twavefront.render_frame(scene, cam, worker.STATS, 0, isect, occl, sort_rays=True)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
