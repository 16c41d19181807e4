"""The treelet driver's passes (``csrc/treelet_driver.cu``) against the plain
PyTorch driver of ``ops/treelets.py``.

On the CPU the kernels' source is built with g++ under ``csrc/host_shim.h``
(``treelet_driver_kernel.load_host_kernels()``: each block run by one
thread, in turn) and driven through ``treelet_intersect`` with the
driver's passes swapped for that library's (``treelets._passes``): the
glue the CUDA path takes. Each case is held to the bit against the
plain driver on the same rays: the key pass's caps, sort keys and nearest
treelets against ``key_pass_plain``, the sort's order, every K3 launch's
inputs (``seg_list``, ``seg_entry``, ``seg_gmask``, the sorted rays, caps
and any-hit rows, recorded around K3)
and the final ``Hit`` (with ``stats``, the per-segment rows). The scenes
are seeded triangle soups cut into K = 1, 5 and more than 16 treelets; the
rays are seeded, some with zero direction components and some outside
the scene; the cases cross presorted and sorted launches, ``step_cull``
on and off, scalar and per-ray caps with parked lanes (cap 0), the any-hit
mask, ``hit_only``, ``nearest_first``, ``e_cap``, ``sort_chunk`` 2,
``stats``, and segments of 8 and 40 groups (one and two mask words).

The rounds driver builds each round's K3 launch through the same passes:
its host loop (``treelet_intersect_rounds_plain``) and its device loop
(``rounds_on_device`` with the host-shim F1 and F2 of
``csrc/oracle_bvh.cu``), closest and any hit on each scene, are held to
the bit against the plain passes in every round's K3 inputs, the ``Hit``,
K5's counts and the round count. ~30 s alone (K3's plain version takes
most of it; it runs once a launch index across a case's traces).

Also here: the wrapper's refusals, a CPU call that takes the plain driver
and counts no launch, and, marked ``gpu``, the CUDA build against the plain
driver on the card (the sponza1080 table at 2,088,960 rays, and every case
above) and a sorted launch captured in a CUDA graph, with no sync.
"""

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.ops import oracle_kernels as ok
from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelet_driver_kernel as tdk
from raytracer3_tpu_torch.ops import treelets
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

BG = 100000.0
N_RAYS = 8 * 128 * 3 + 100  # not a segment multiple
SCENES = {"k1": 600, "k5": 150, "k30": 30}  # max_tris of a 600-triangle soup


def _soup(n, seed=0, spread=10.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _tables(scene, dev="cpu"):
    tt = treelets.build_treelets_host(*_soup(600), leaf_size=4, width=8, max_tris=SCENES[scene])
    return treelets.tables_to_device(tt, dev)


def _rays(n, seed=1, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    o[:40] *= 4.0  # outside the scene box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[40:90, 0] = 0.0
    d[90:120, 1] = -0.0
    d[120:140, :2] = 0.0  # along z
    tmax = rng.uniform(0.5, 30.0, n).astype(np.float32)
    tmax[:7] = 0.0  # parked lanes
    tmax[200:207] = 0.0
    mask = rng.uniform(size=n) < 0.5
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax), torch.from_numpy(mask))


CASES = {
    "sorted": dict(),
    "sorted_cull": dict(step_cull=True),
    "presorted": dict(presorted=True, step_cull=True, max_groups=32),
    "presorted_no_cull": dict(presorted=True),
    "shadow": dict(t_max="per_ray", any_hit=True, hit_only=True, step_cull=True),
    "anyhit_mask": dict(t_max="per_ray", anyhit_mask=True, step_cull=True),
    "nearest_first": dict(nearest_first=True, step_cull=True),
    "nearest_first_mask": dict(nearest_first=True, t_max="per_ray", anyhit_mask=True),
    "e_cap": dict(e_cap=2, step_cull=True),
    "sort_chunk": dict(sort_chunk=2, step_cull=True),
    "stats": dict(stats=True, step_cull=True),
    "groups_8": dict(sublanes=64, max_groups=8, step_cull=True),
    "groups_40": dict(sublanes=320, max_groups=64, step_cull=True),
}


def _kwargs(case, rays):
    _, _, tmax, mask = rays
    kw = dict(CASES[case])
    kw.setdefault("sublanes", 8)
    if kw.get("t_max") == "per_ray":
        kw["t_max"] = tmax
    if kw.get("anyhit_mask"):
        kw["anyhit_mask"] = mask
    return kw


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.device == b.device, what
    differ = (_bits(a) != _bits(b)).sum().item()
    assert differ == 0, f"{what}: {differ} entries differ"


_K3_INPUTS = ("seg_list", "seg_entry", "seg_gmask", "origins", "directions", "t_cap", "anyhit_row")


PLAIN = (treelets._prepare, treelets._launch_for)


def _trace(monkeypatch, tt, rays, kw, passes, driver=None, launches=None):
    """``treelet_intersect`` (or ``driver(tt, origins, directions, **kw)``)
    through the driver's ``passes`` (prepare, launch_for), K3 wrapped in a
    recorder: (result, [each launch's inputs]).

    With ``launches`` (a list shared by several traces), K3 runs once for
    each launch index: a trace's i-th launch must have, to the bit, the
    inputs of the first trace that reached launch i, and takes its rows."""
    calls = []
    k3 = ttk.packet_intersect_segments

    def record(tt_, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, anyhit_row=None, **k):
        call = dict(seg_list=seg_list, seg_entry=seg_entry, seg_gmask=seg_gmask, origins=origins,
                    directions=directions, t_cap=t_cap, anyhit_row=anyhit_row, kw=k)
        i = len(calls)
        calls.append(call)
        if launches is not None and i < len(launches):
            first, out = launches[i]
            assert call["kw"] == first["kw"]
            for f in _K3_INPUTS:
                _assert_same(call[f], first[f], f"launch {i}: {f}")
            return out
        out = k3(tt_, seg_list, seg_entry, seg_gmask, origins, directions, t_cap, anyhit_row=anyhit_row, **k)
        if launches is not None:
            launches.append((call, out))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(ttk, "packet_intersect_segments", record)
        mp.setattr(treelets, "_passes", lambda origins: passes)
        out = (driver or treelets.treelet_intersect)(tt, rays[0], rays[1], **kw)
    return out, calls


def _hold_to_plain(monkeypatch, tt, rays, kw, lib):
    """Every output of the kernels' driver against the plain driver's."""
    o, d = rays[0], rays[1]
    p, _, _ = ttk._segment_groups(kw["sublanes"], kw.get("max_groups", 32))
    n = o.shape[0]
    n_pad = -(-n // p) * p
    dev = o.device
    sort = not kw.get("presorted", False) and tt.num_treelets > 1
    t_max = kw.get("t_max", BG)
    # The key pass against the plain one on the padded rays.
    cap, key, tid = tdk.key_pass(lib, tt.aabb, o, d, t_max, p=p, t_min=1e-4, step_cull=kw.get("step_cull", False),
                                 sort=sort, nearest_tid=True)
    o_p = torch.cat([o, torch.full((n_pad - n, 3), 1e30, device=dev)])
    d_p = torch.cat([d, torch.ones((n_pad - n, 3), device=dev)])
    c_p = torch.cat([t_max if isinstance(t_max, torch.Tensor) else torch.full((n,), t_max, device=dev),
                     torch.zeros((n_pad - n,), device=dev)])
    cap_p, key_p, tid_p = treelets.key_pass_plain(tt.aabb, o_p, d_p, c_p, t_min=1e-4,
                                                  step_cull=kw.get("step_cull", False), sort=sort)
    _assert_same(cap, cap_p, "cap")
    _assert_same(key, key_p, "key")
    _assert_same(tid, tid_p, "tid")
    if sort:
        g = kw.get("sort_chunk", 1)
        _assert_same(treelets._sort_order(key, g), treelets._sort_order(key_p, g), "order")
    # Every K3 launch's inputs, and the result.
    got, got_calls = _trace(monkeypatch, tt, rays, kw, treelets._kernel_passes(lib))
    want, want_calls = _trace(monkeypatch, tt, rays, kw, PLAIN)
    assert len(got_calls) == len(want_calls) == (2 if kw.get("nearest_first") and sort else 1)
    for i, (g_call, w_call) in enumerate(zip(got_calls, want_calls)):
        assert g_call["kw"] == w_call["kw"]
        for f in _K3_INPUTS:
            _assert_same(g_call[f], w_call[f], f"launch {i}: {f}")
    if kw.get("stats"):
        _assert_same(got[1], want[1], "stats rows")
        got, want = got[0], want[0]
    for f in got._fields:
        _assert_same(getattr(got, f), getattr(want, f), f"Hit.{f}")
    return got, want_calls


@pytest.fixture(scope="module")
def host_lib():
    return tdk.load_host_kernels()


@pytest.fixture(scope="module")
def oracle_host_lib():
    return ok.load_host_kernels()


@pytest.fixture(scope="module")
def scenes():
    return {name: _tables(name) for name in SCENES}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernels_match_plain_driver(scene, case, scenes, host_lib, monkeypatch):
    tt = scenes[scene]
    assert {"k1": tt.num_treelets == 1, "k5": tt.num_treelets == 5, "k30": tt.num_treelets > 16}[scene]
    rays = _rays(N_RAYS)
    kw = _kwargs(case, rays)
    before = dict(ttk.LAUNCHES)
    hit, calls = _hold_to_plain(monkeypatch, tt, rays, kw, host_lib)
    assert ttk.LAUNCHES == before  # the host build counts nothing
    # The case reaches what it is for.
    gmask = calls[0]["seg_gmask"]
    assert (gmask != 0).any()
    assert 0 < int(hit.hit.sum()) < N_RAYS
    if case == "groups_40":
        assert gmask.shape[-1] == 2
    if case == "e_cap" and tt.num_treelets > 2:
        assert (gmask[:, 2:] == 0).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_rounds_driver_kernels_match_plain_driver(scene, any_hit, scenes, host_lib, oracle_host_lib, monkeypatch):
    # The rounds driver builds each round's K3 launch through the single
    # pass's launch pass: the host loop and the device loop (with the
    # host-shim F1 and F2), each through the metadata kernel's host build
    # against the plain passes, every round's K3 inputs and the final Hit,
    # K5 counts and round count to the bit. Round i's K3 inputs are also
    # the same in all four runs (the device loop's rounds past the host
    # loop's last launch steps whose group mask is 0), so K3 runs once a
    # round.
    tt = scenes[scene]
    rays = _rays(N_RAYS)
    kw = dict(sublanes=8, any_hit=any_hit, t_max=rays[2] if any_hit else BG, stats=True, return_rounds=True)
    steps = (lambda *a: ok.rounds_pick(oracle_host_lib, *a, None),
             lambda *a: ok.rounds_merge(oracle_host_lib, *a, None))

    def on_device(tt_, o, d, **k):
        return treelets.rounds_on_device(tt_, o, d, *steps, **k)

    launches = []
    for driver in (treelets.treelet_intersect_rounds_plain, on_device):
        (want, w_counts, w_rounds), want_calls = _trace(monkeypatch, tt, rays, kw, PLAIN, driver, launches)
        (got, g_counts, g_rounds), got_calls = _trace(monkeypatch, tt, rays, kw, treelets._kernel_passes(host_lib),
                                                      driver, launches)
        assert int(g_rounds) == int(w_rounds) >= 1
        # The host loop launches one K3 a round; the device loop all K.
        assert len(got_calls) == len(want_calls) == (tt.num_treelets if driver is on_device else int(w_rounds))
        if driver is on_device:
            assert all((c["seg_gmask"] == 0).all() for c in got_calls[int(w_rounds):])
        _assert_same(g_counts, w_counts, f"{driver.__name__}: counts")
        for f in got._fields:
            _assert_same(getattr(got, f), getattr(want, f), f"{driver.__name__}: Hit.{f}")
        assert 0 < int(got.hit.sum()) < N_RAYS
        assert (want_calls[0]["seg_gmask"] != 0).any()  # the first round traces something


def test_wrapper_refuses_other_devices_dtypes_and_shapes(scenes, host_lib):
    tt = scenes["k5"]
    o, d, tmax, _ = _rays(64)
    kw = dict(p=1024, t_min=1e-4, step_cull=True, sort=True)
    with pytest.raises(ValueError, match="cannot take tensors"):
        tdk.key_pass(type("CudaBuild", (), {"rt3_device_type": "cuda"})(), tt.aabb, o, d, BG, **kw)
    with pytest.raises(ValueError, match="origins must be"):
        tdk.key_pass(host_lib, tt.aabb, o.double(), d, BG, **kw)
    with pytest.raises(ValueError, match="t_max must be"):
        tdk.key_pass(host_lib, tt.aabb, o, d, tmax[:10], **kw)
    with pytest.raises(ValueError, match="aabb must be"):
        tdk.key_pass(host_lib, torch.zeros((tdk.MAX_TREELETS + 1, 8)), o, d, BG, **kw)
    cap, key, _ = tdk.key_pass(host_lib, tt.aabb, o, d, BG, **kw)
    order = torch.argsort(key, stable=True)
    mkw = dict(p=1024, group_rays=1024, n_words=1, t_min=1e-4)
    with pytest.raises(ValueError, match="do not make segments"):
        tdk.meta_pass(host_lib, tt.aabb, o, d, cap[:1000], None, None, **mkw)
    with pytest.raises(ValueError, match="do not make segments"):
        tdk.meta_pass(host_lib, tt.aabb, o, d, cap, None, order, **dict(mkw, n_words=2))
    with pytest.raises(ValueError, match="order must be"):
        tdk.meta_pass(host_lib, tt.aabb, o, d, cap, None, order.to(torch.int32), **mkw)
    with pytest.raises(ValueError, match="anyhit must be"):
        tdk.meta_pass(host_lib, tt.aabb, o, d, cap, torch.zeros(65, dtype=torch.bool), order, **mkw)
    with pytest.raises(ValueError, match="exclude each other"):
        tdk.meta_pass(host_lib, tt.aabb, o, d, cap, None, order, only_tid=key, exclude_tid=key, **mkw)
    out = tdk.meta_pass(host_lib, tt.aabb, o, d, cap, None, order, **mkw)
    assert out[0].shape == (1024, 3) and out[4].shape == (1, 5) and out[6].shape == (1, 5, 1)


def test_cpu_call_takes_plain_driver_and_counts_no_launch(scenes, monkeypatch):
    tt = scenes["k5"]
    o, d, tmax, mask = _rays(N_RAYS)

    def refuse(*a, **k):
        raise AssertionError("a CPU call took the driver's kernels")

    monkeypatch.setattr(tdk, "load_kernels", refuse)
    monkeypatch.setattr(tdk, "key_pass", refuse)
    monkeypatch.setattr(tdk, "meta_pass", refuse)
    before = dict(ttk.LAUNCHES)
    hit = treelets.treelet_intersect(tt, o, d, t_max=tmax, anyhit_mask=mask, sublanes=8, step_cull=True)
    treelets.segment_launch(tt, o, d, sublanes=8, presorted=True)
    assert ttk.LAUNCHES == before and hit.hit.any()
    assert all(ttk.LAUNCHES[k] == before[k] for k in ttk.TREELET_DRIVER_KEYS)


# -- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _to(rays, dev):
    return tuple(x.to(dev) for x in rays)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["k5", "k30"])
def test_cuda_kernels_match_plain_driver_on_card(scene, monkeypatch):
    # The CUDA build against the plain driver run on the card: every case,
    # each output to the bit, one key and one metadata pass a trace.
    dev = _card()
    tt = _tables(scene, dev)
    lib = tdk.load_kernels()
    rays = _to(_rays(N_RAYS), dev)
    for case in CASES:
        kw = _kwargs(case, rays)
        before = {k: ttk.LAUNCHES[k] for k in ttk.TREELET_DRIVER_KEYS}
        _hold_to_plain(monkeypatch, tt, rays, kw, lib)
        launched = {k: ttk.LAUNCHES[k] - before[k] for k in ttk.TREELET_DRIVER_KEYS}
        # The key pass held alone, then the two traces: the driver's own and the plain one.
        two_phase = int(kw.get("nearest_first", False))
        assert launched == {"treelet_key": 2, "treelet_meta": 1 + two_phase}, (case, launched)


@pytest.mark.gpu
def test_cuda_sponza1080_table_bit_equal_on_card(tmp_path, monkeypatch):
    # The sponza1080 table (K = 5) at a 1920x1088 wavefront's 2,088,960
    # rays: the presorted primaries, a sorted bounce set from their hits and
    # a capped any-hit set, each launch as the treelet backend makes it.
    from raytracer3_tpu_torch.render import wavefront as twavefront
    from raytracer3_tpu_torch.scene import procedural as tprocedural
    from raytracer3_tpu_torch.utils.config import RenderSettings

    dev = _card()
    world = tprocedural.sponza_world(8, cache_dir=str(tmp_path))
    backend = world.trace_backend("auto", device=dev)
    tt = backend.meta
    assert tt.num_treelets == 5
    cam = tprocedural.atrium_camera(aspect=1920 / 1088, device=dev)
    o, d, _ = twavefront.sample_rays(cam, RenderSettings(width=1920, height=1088, bounces=4, samples=1), 3, 0)
    assert o.shape[0] == 2_088_960
    g = torch.Generator(device=dev).manual_seed(5)
    primary = dict(sublanes=512, presorted=True, step_cull=True, max_groups=treelets.MAX_GROUPS_PRIMARY)
    sorted_kw = dict(sublanes=1024, step_cull=True, max_groups=treelets.MAX_GROUPS_SORTED)
    def plain(fn, *args, **kw):
        with monkeypatch.context() as mp:
            mp.setattr(treelets, "_passes", lambda origins: PLAIN)
            return fn(*args, **kw)

    hit = treelets.treelet_intersect(tt, o, d, **primary)
    hit_p = plain(treelets.treelet_intersect, tt, o, d, **primary)
    for f in hit._fields:
        _assert_same(getattr(hit, f), getattr(hit_p, f), f"primaries: Hit.{f}")
    pos = torch.where(hit.hit[:, None], o + hit.t[:, None] * d, 1e30)
    nd = torch.randn((o.shape[0], 3), generator=g, device=dev)
    nd = nd / nd.norm(dim=-1, keepdim=True)
    tmax = torch.rand((o.shape[0],), generator=g, device=dev) * 20.0
    for name, kw in (("bounce", sorted_kw), ("shadow", dict(sorted_kw, t_max=tmax, any_hit=True)),
                     ("mixed", dict(sorted_kw, t_max=tmax, anyhit_mask=tmax > 10.0))):
        got = treelets.segment_launch(tt, pos, nd, **kw)
        want = plain(treelets.segment_launch, tt, pos, nd, **kw)
        for f in _K3_INPUTS + ("order",):
            _assert_same(getattr(got, f), getattr(want, f), f"{name}: {f}")
        hit = treelets.treelet_intersect(tt, pos, nd, **kw)
        hit_p = plain(treelets.treelet_intersect, tt, pos, nd, **kw)
        for f in hit._fields:
            _assert_same(getattr(hit, f), getattr(hit_p, f), f"{name}: Hit.{f}")
        assert hit.hit.any() and not hit.hit.all()


@pytest.mark.gpu
def test_cuda_sorted_launch_captures_in_a_graph():
    # A sorted launch (key pass, argsort, metadata pass, K3) captured in a
    # CUDA graph equals the eager one, and the eager one never syncs.
    dev = _card()
    tt = _tables("k5", dev)
    o, d, tmax, mask = _to(_rays(N_RAYS), dev)
    kw = dict(t_max=tmax, anyhit_mask=mask, sublanes=8, step_cull=True)
    treelets.treelet_intersect(tt, o, d, **kw)  # build and warm
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = treelets.treelet_intersect(tt, o, d, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        treelets.treelet_intersect(tt, o, d, **kw)
        with torch.cuda.graph(graph, stream=side):
            captured = treelets.treelet_intersect(tt, o, d, **kw)
    before = {k: ttk.LAUNCHES[k] for k in ttk.TREELET_DRIVER_KEYS}
    graph.replay()
    torch.cuda.synchronize(dev)
    for f in eager._fields:
        _assert_same(getattr(captured, f), getattr(eager, f), f"Hit.{f}")
    assert {k: ttk.LAUNCHES[k] for k in ttk.TREELET_DRIVER_KEYS} == before  # a replay counts nothing itself
