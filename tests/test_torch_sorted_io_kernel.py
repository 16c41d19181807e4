"""The sorted launch IO's passes (``csrc/sorted_io.cu``) against their plain
PyTorch versions in ``render/wavefront.py``.

On the CPU the kernels' source is built with g++ under
``csrc/host_shim.h`` (``sorted_io_kernel.load_host_kernels()``: each
thread run in turn) and driven through ``sort_key_pos_dir``,
``sorted_trace`` and ``sorted_occlusion`` with the wavefront's library
swapped for that build (``wavefront._sorted_io``): the glue the CUDA path
takes. Each case is held to the bit against the plain versions on the
same lanes: the key (bounds given or from the alive lanes, every lane
dead, degenerate bounds, zero and negative-zero direction components,
parked and NaN lanes), the sort's order, the launch's inputs (recorded
around the launch), the ``Hit`` of a closest-hit trace through K1/K2's
and K4's plain versions (with and without the instance id) and the
occlusion bits of an any-hit trace. A frame of the viewer's compiled step
on the atrium through K1/K2 (4 bounces, NEE: a sorted shadow and a sorted
next-hit launch on bounces 0-2) runs each pass 6 times and leaves the film
of the plain path, to the bit.

Also here: the wrapper's refusals, a CPU call that takes the plain path and
counts no launch, and, marked ``gpu``, the CUDA build against the plain
path run on the card and a sorted launch captured in a CUDA graph with no
sync.
"""

import collections

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.app import viewer as viewer_mod
from raytracer3_tpu_torch.app import world as world_mod
from raytracer3_tpu_torch.ops import rng
from raytracer3_tpu_torch.ops import sorted_io_kernel as sio
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops.intersect import Hit
from raytracer3_tpu_torch.render import film as film_mod
from raytracer3_tpu_torch.render import wavefront as twavefront
from raytracer3_tpu_torch.scene import procedural
from raytracer3_tpu_torch.utils.config import RenderSettings
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

N = 3000
BG = ttk._BG


@pytest.fixture(scope="module")
def host_lib():
    return sio.load_host_kernels()


def _worlds():
    """The atrium (detail 1), traced as one table by K1/K2, and the
    instanced atrium (the shell and 14 columns), traced by K4."""
    w = viewer_mod.atrium_world(1)
    shell, column, transforms = procedural.instanced_atrium(1)
    iw = world_mod.World()
    handles = []
    for m in (shell, column):
        base = len(iw._materials["base_color"])
        for k in range(len(m["base_color"])):
            iw.add_material(m["base_color"][k], m["emission"][k], m["metallic"][k], m["roughness"][k])
        handles.append(iw.add_mesh(m["positions"], m["normals"], m["uvs"], m["indices"], m["geo_id"] + base))
    iw.spawn(handles[0])
    for t in transforms:
        iw.spawn(handles[1], transform=t)
    return w, iw


def _backends(device, **tlas_kw):
    """{"k12", "two_level"} backends on ``device`` and the atrium's bounds."""
    w, iw = _worlds()
    scene = w.scene(device=device)
    k12 = w.trace_backend("packet", device=device)
    assert not k12.self_sorting and k12.meta.inst_table is None
    backends = {"k12": k12, "two_level": iw.tlas_backend(device=device, **tlas_kw)}
    return backends, (scene.positions.amin(0), scene.positions.amax(0))


@pytest.fixture(scope="module")
def backends():
    return _backends("cpu", leaf_size=4, width=8)


def _lanes(n=N, seed=3):
    """Seeded lanes in the atrium: positions, unit directions with zero and
    negative-zero components, some parked at 1e30, a NaN lane, a third
    dead; caps."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9.0, 9.0, (n, 3)).astype(np.float32) + np.float32([0.0, 4.0, 0.0])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[40:90, 0] = 0.0
    d[90:120, 1] = -0.0
    d[120:140, :2] = 0.0
    alive = rng.uniform(size=n) < 0.67
    pos[~alive & (np.arange(n) % 2 == 0)] = 1e30  # parked, as the wavefront parks dead lanes
    pos[7] = np.nan
    cap = rng.uniform(0.5, 20.0, n).astype(np.float32)
    cap[::11] = BG
    return torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(alive), torch.from_numpy(cap)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    assert torch.equal(_bits(got), _bits(want)), f"{what}: {int((_bits(got) != _bits(want)).sum())} lanes differ"


def _assert_same_hit(got, want, what: str) -> None:
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), (what, f)
        if g is not None:
            _assert_same(g, w, f"{what}: Hit.{f}")


def _recording(fn, calls):
    """``fn`` that records the (contiguous copies of the) inputs it gets."""
    def rec(*args):
        calls.append([a.contiguous().clone() for a in args])
        return fn(*args)

    return rec


KEY_CASES = {
    "bounds": lambda pos, d, alive, b: (pos, d, alive, b),
    "alive_bounds": lambda pos, d, alive, b: (pos, d, alive, None),
    "all_dead_bounds": lambda pos, d, alive, b: (pos, d, torch.zeros_like(alive), b),
    "all_dead": lambda pos, d, alive, b: (pos, d, torch.zeros_like(alive), None),
    "degenerate_bounds": lambda pos, d, alive, b: (pos, d, alive, (b[0], b[0].clone())),
    "flat_alive": lambda pos, d, alive, b: (torch.where(torch.arange(pos.shape[0], device=pos.device)[:, None] % 3 == 0,
                                                        pos, torch.tensor([1.0, 2.0, 3.0], device=pos.device)), d,
                                            alive, None),
    "one_lane": lambda pos, d, alive, b: (pos[:1], d[:1], alive[:1], b),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_key_and_order_match_plain(case, host_lib, backends, monkeypatch):
    pos, d, alive, _ = _lanes()
    args = KEY_CASES[case](pos, d, alive, backends[1])
    want = twavefront.sort_key_pos_dir_plain(*args)
    monkeypatch.setattr(twavefront, "_sorted_io", lambda device: host_lib)
    got = twavefront.sort_key_pos_dir(*args)
    _assert_same(got, want, f"{case}: key")
    _assert_same(torch.argsort(got, stable=True), torch.argsort(want, stable=True), f"{case}: order")
    if case in ("all_dead", "all_dead_bounds"):
        assert (got >= 1 << 30).all()
    elif case != "one_lane":  # the key sorts something (a flat box leaves the octants and the box's corners)
        assert len(torch.unique(got)) > (16 if case == "degenerate_bounds" else 100)


@pytest.mark.parametrize("scene", ["k12", "two_level"])
def test_sorted_trace_matches_plain(scene, host_lib, backends, monkeypatch):
    backend, bounds = backends[0][scene], backends[1]
    pos, d, alive, _ = _lanes()
    pos = torch.nan_to_num(pos, nan=1e30)  # a NaN origin is no ray the wavefront makes
    calls_p, calls_k = [], []
    want = twavefront.sorted_trace(_recording(backend.intersect, calls_p), pos, d, alive, bounds)
    monkeypatch.setattr(twavefront, "_sorted_io", lambda device: host_lib)
    got = twavefront.sorted_trace(_recording(backend.intersect, calls_k), pos, d, alive, bounds)
    assert len(calls_p) == len(calls_k) == 1
    for name, g, w in zip(("origins", "directions"), calls_k[0], calls_p[0]):
        _assert_same(g, w, f"{scene}: launch {name}")
    _assert_same_hit(got, want, scene)
    assert (got.inst is not None) == (scene == "two_level")
    assert 0 < int(got.hit.sum()) < int(alive.sum())


@pytest.mark.parametrize("scene", ["k12", "two_level"])
def test_sorted_occlusion_matches_plain(scene, host_lib, backends, monkeypatch):
    backend, bounds = backends[0][scene], backends[1]
    pos, d, alive, cap = _lanes(seed=4)
    pos = torch.nan_to_num(pos, nan=1e30)
    calls_p, calls_k = [], []
    want = twavefront.sorted_occlusion(_recording(backend.occluded, calls_p), pos, d, cap, alive, bounds)
    monkeypatch.setattr(twavefront, "_sorted_io", lambda device: host_lib)
    got = twavefront.sorted_occlusion(_recording(backend.occluded, calls_k), pos, d, cap, alive, bounds)
    for name, g, w in zip(("origins", "directions", "caps"), calls_k[0], calls_p[0]):
        _assert_same(g, w, f"{scene}: launch {name}")
    _assert_same(got, want, f"{scene}: bits")
    _assert_same(got, backend.occluded(pos, d, cap), f"{scene}: bits against the unsorted launch")
    assert 0 < int(got.sum()) < N


def test_wrapper_refuses_other_devices_dtypes_and_shapes(host_lib):
    pos, d, alive, cap = _lanes(64)
    lo, hi = torch.zeros(3), torch.ones(3)
    with pytest.raises(ValueError, match="cannot take tensors"):
        sio.launch_key(type("CudaBuild", (), {"rt3_device_type": "cuda"})(), pos, d, alive, lo, hi)
    with pytest.raises(ValueError, match="pos must be"):
        sio.launch_key(host_lib, pos.double(), d, alive, lo, hi)
    with pytest.raises(ValueError, match="alive must be"):
        sio.launch_key(host_lib, pos, d, alive.to(torch.uint8), lo, hi)
    with pytest.raises(ValueError, match="lo must be"):
        sio.launch_key(host_lib, pos, d, alive, lo.double(), hi)
    with pytest.raises(ValueError, match="hi must be"):
        sio.launch_key(host_lib, pos, d, alive, lo, hi[:2])
    perm = torch.argsort(sio.launch_key(host_lib, pos, d, alive, lo, hi), stable=True)
    with pytest.raises(ValueError, match="perm must be"):
        sio.launch_in(host_lib, perm.to(torch.int32), pos, d)
    with pytest.raises(ValueError, match="t_max must be"):
        sio.launch_in(host_lib, perm, pos, d, cap[:10])
    with pytest.raises(ValueError, match="directions must be"):
        sio.launch_in(host_lib, perm, pos, d[:, :2])
    o_s, d_s, cap_s = sio.launch_in(host_lib, perm, pos, d, cap)
    assert o_s.shape == (64, 3) and cap_s.shape == (64,) and torch.equal(cap_s, cap[perm])
    with pytest.raises(ValueError, match="perm must be"):
        sio.launch_out_bits(host_lib, perm, cap[:10] > 1.0)
    with pytest.raises(ValueError, match="bits must be"):
        sio.launch_out_bits(host_lib, perm, (cap > 1.0).to(torch.uint8))
    h = Hit.miss((64,), device="cpu")
    with pytest.raises(ValueError, match="uv must be"):
        sio.launch_out_hit(host_lib, perm, h._replace(uv=h.uv[:, :1]))
    with pytest.raises(ValueError, match="perm must be"):
        sio.launch_out_hit(host_lib, perm[:10], h)
    out = sio.launch_out_hit(host_lib, perm, h._replace(inst=torch.full((64,), -1, dtype=torch.int64)))
    assert out.inst.dtype == torch.int32 and not out.hit.any()
    # Empty sets launch nothing and give empty tensors.
    e = sio.launch_key(host_lib, pos[:0], d[:0], alive[:0], lo, hi)
    assert e.shape == (0,) and e.dtype == torch.int32


def test_cpu_call_takes_plain_path_and_counts_no_launch(backends, monkeypatch):
    backend, bounds = backends[0]["k12"], backends[1]
    pos, d, alive, cap = _lanes()
    pos = torch.nan_to_num(pos, nan=1e30)

    def refuse(*a, **k):
        raise AssertionError("a CPU call took the sorted IO's kernels")

    for name in ("load_kernels", "load_host_kernels", "launch_key", "launch_in", "launch_out_hit",
                 "launch_out_bits"):
        monkeypatch.setattr(sio, name, refuse)
    before = dict(ttk.LAUNCHES)
    key = twavefront.sort_key_pos_dir(pos, d, alive, bounds)
    hit = twavefront.sorted_trace(backend.intersect, pos, d, alive, bounds)
    bits = twavefront.sorted_occlusion(backend.occluded, pos, d, cap, alive, bounds)
    assert ttk.LAUNCHES == before and all(ttk.LAUNCHES[k] == before[k] for k in ttk.SORTED_IO_KEYS)
    assert key.dtype == torch.int32 and hit.hit.any() and bits.any()


def _counting(monkeypatch) -> collections.Counter:
    """Counts each pass the wrapper launches (the host build counts none in
    ``LAUNCHES``)."""
    counts = collections.Counter()
    launch = sio.c_launch

    def counted(lib, name, dev, *args):
        counts[name] += 1
        return launch(lib, name, dev, *args)

    monkeypatch.setattr(sio, "c_launch", counted)
    return counts


def test_atrium_frame_runs_six_of_each_pass_and_keeps_the_film(host_lib, monkeypatch):
    # The atrium1080 frame's settings (4 bounces, NEE, radiance clamp 50,
    # blue noise) on a small film through the viewer's compiled step over
    # K1/K2's plain version: bounces 0-2 each sort their shadow launch and
    # their next-hit launch (the tail's launch goes unsorted), so a frame
    # runs 6 key, 6 gather and 6 scatter passes; the film is the plain
    # path's to the bit.
    w = viewer_mod.atrium_world(2)
    scene = w.scene(device="cpu")
    backend = w.trace_backend("packet", device="cpu")
    settings = RenderSettings(width=32, height=16, bounces=4, samples=1, radiance_clamp=50.0)
    cam = procedural.atrium_camera(aspect=2.0, device="cpu")
    blue_noise = torch.as_tensor(rng.generate_blue_noise(64, seed=0), dtype=torch.float32)

    def frame():
        fn = viewer_mod.make_default_frame_fn(scene, settings, backend=backend, blue_noise=blue_noise)
        film = film_mod.Film.create(settings.height, settings.width, device="cpu")
        film, display = fn(film, cam, 5)
        return film.accum, display

    want = frame()
    monkeypatch.setattr(twavefront, "_sorted_io", lambda device: host_lib)
    counts = _counting(monkeypatch)
    got = frame()
    assert dict(counts) == {"launch_key": 6, "launch_in": 6, "launch_out": 6}
    _assert_same(got[0], want[0], "film")
    _assert_same(got[1], want[1], "display")
    assert float(got[0].mean()) > 0.0


# -- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["k12", "two_level"])
def test_cuda_passes_match_plain_on_card(scene, monkeypatch):
    # The CUDA build against the plain path run on the card: every key
    # case, the launch's inputs, the Hit and the bits, each to the bit, and
    # one key, gather and scatter pass a sorted launch.
    dev = _card()
    backend = _card_backends(dev)[scene]
    pos, d, alive, cap = (x.to(dev) for x in _lanes())
    bounds = _card_bounds(dev)
    plain = lambda device: None  # noqa: E731
    for case, make in KEY_CASES.items():
        args = make(pos, d, alive, bounds)
        got = twavefront.sort_key_pos_dir(*args)
        with monkeypatch.context() as mp:
            mp.setattr(twavefront, "_sorted_io", plain)
            want = twavefront.sort_key_pos_dir(*args)
        _assert_same(got, want, f"{case}: key")
    pos = torch.nan_to_num(pos, nan=1e30)
    for what, run in (("trace", lambda f: twavefront.sorted_trace(f, pos, d, alive, bounds)),
                      ("occlusion", lambda f: twavefront.sorted_occlusion(f, pos, d, cap, alive, bounds))):
        fn = backend.intersect if what == "trace" else backend.occluded
        calls_k, calls_p = [], []
        before = {k: ttk.LAUNCHES[k] for k in ttk.SORTED_IO_KEYS}
        got = run(_recording(fn, calls_k))
        launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.SORTED_IO_KEYS}
        with monkeypatch.context() as mp:
            mp.setattr(twavefront, "_sorted_io", plain)
            want = run(_recording(fn, calls_p))
        assert launched == {"launch_key": 1, "launch_in": 1, "launch_out": 1}, (what, launched)
        for k, (g, w) in enumerate(zip(calls_k[0], calls_p[0])):
            _assert_same(g, w, f"{scene} {what}: launch input {k}")
        if what == "trace":
            _assert_same_hit(got, want, scene)
        else:
            _assert_same(got, want, f"{scene}: bits")


_CARD = {}


def _card_backends(dev):
    """``_backends`` on the card, built once."""
    if not _CARD:
        _CARD["backends"], _CARD["bounds"] = _backends(dev)
    return _CARD["backends"]


def _card_bounds(dev):
    _card_backends(dev)
    return _CARD["bounds"]


@pytest.mark.gpu
def test_cuda_sorted_launch_captures_in_a_graph():
    # A sorted trace and a sorted occlusion (key, argsort, gather, K1/K2,
    # scatter) captured in a CUDA graph equal the eager ones, and the eager
    # ones never sync.
    dev = _card()
    backend = _card_backends(dev)["k12"]
    bounds = _card_bounds(dev)
    pos, d, alive, cap = (x.to(dev) for x in _lanes())
    pos = torch.nan_to_num(pos, nan=1e30)

    def both():
        return (twavefront.sorted_trace(backend.intersect, pos, d, alive, bounds),
                twavefront.sorted_occlusion(backend.occluded, pos, d, cap, alive, bounds))

    both()  # build and warm
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = both()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        both()
        with torch.cuda.graph(graph, stream=side):
            captured = both()
    before = {k: ttk.LAUNCHES[k] for k in ttk.SORTED_IO_KEYS}
    graph.replay()
    torch.cuda.synchronize(dev)
    _assert_same_hit(captured[0], eager[0], "captured trace")
    _assert_same(captured[1], eager[1], "captured bits")
    assert {k: ttk.LAUNCHES[k] for k in ttk.SORTED_IO_KEYS} == before  # a replay counts nothing itself
