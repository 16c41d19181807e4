"""Kernels E (``wide_walk_kernel``), F1 and F2 (``rounds_pick_kernel``,
``rounds_merge_kernel``) on the card, marked ``gpu``: the wide walk and
K3's rounds driver on CUDA tensors against their plain versions on the
same card, bit for bit (the rounds driver also in its round count and K5
counts, against the host loop both over the driver's metadata kernel and
over the plain PyTorch driver passes), each launch counted. No JAX here: the CPU-side comparisons, with
the JAX reference, are ``tests/test_torch_device_loops.py``."""

import numpy as np
import pytest
import torch

from raytracer3_tpu_torch.ops import traverse_kernel as ttk
from raytracer3_tpu_torch.ops import treelets as ttreelets
from raytracer3_tpu_torch.ops import wide_bvh as twide
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _hits_equal(got, want):
    for name in ("t", "uv", "prim_id", "hit"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b)), name


def _soup(n, seed, spread, size):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return (c, c + rng.normal(0, size, (n, 3)).astype(np.float32), c + rng.normal(0, size, (n, 3)).astype(np.float32))


def _rays(n, seed, spread, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.gpu
def test_device_loops_on_card(monkeypatch):
    """E and the device rounds driver on the card against their plain
    versions on the card, bit for bit (rounds and K5 counts equal): one E
    launch a call, one F1, one F2 and one metadata pass a round, K rounds
    a call."""
    dev = _card()
    tris = tuple(torch.from_numpy(v).to(dev) for v in _soup(5000, 81, 4.0, 0.3))
    wb = twide.build_wide(*tris)
    o, d = _rays(4096, 82, 4.0, dev)
    caps = torch.full((4096,), 2.5, device=dev)
    tt = ttreelets.tables_to_device(
        ttreelets.build_treelets_host(*_soup(900, 0, 10.0, 0.6), leaf_size=4, width=8, max_tris=128), dev)
    n = 8 * 128 * 3 + 17  # three segments and a ragged tail at sublanes=8
    ro, rd = _rays(n, 33, 12.0, dev)
    tmax = torch.from_numpy(np.random.default_rng(35).uniform(1.0, 30.0, n).astype(np.float32)).to(dev)
    before = dict(ttk.LAUNCHES)
    for any_hit in (False, True):
        got = twide.wbvh_intersect(wb, o, d, t_max=caps, any_hit=any_hit)
        _hits_equal(got, twide.wbvh_intersect_plain(wb, o, d, t_max=caps, any_hit=any_hit))
        assert bool(got.hit.any()) and not bool(got.hit.all())
    rounds_run = 0  # the host loop's rounds over the metadata kernel
    for any_hit, t_max in ((False, 1e30), (True, tmax)):
        kw = dict(sublanes=8, stats=True, return_rounds=True, any_hit=any_hit, t_max=t_max)
        got, g_counts, g_rounds = ttreelets.treelet_intersect_rounds(tt, ro, rd, **kw)
        want, w_counts, w_rounds = ttreelets.treelet_intersect_rounds_plain(tt, ro, rd, **kw)
        _hits_equal(got, want)
        assert torch.equal(g_counts, w_counts) and int(g_rounds) == w_rounds >= 1
        rounds_run += w_rounds
        with monkeypatch.context() as mp:
            mp.setattr(ttreelets, "_passes", lambda origins: (ttreelets._prepare, ttreelets._launch_for))
            plain, p_counts, p_rounds = ttreelets.treelet_intersect_rounds_plain(tt, ro, rd, **kw)
        _hits_equal(got, plain)
        assert torch.equal(g_counts, p_counts) and p_rounds == w_rounds
    torch.cuda.synchronize()
    keys = ("wide_closest", "wide_any", "rounds_pick", "rounds_merge", "treelet_meta")
    moved = {k: ttk.LAUNCHES[k] - before[k] for k in keys}
    # The host loop over the metadata kernel adds one metadata pass a round.
    assert moved == {"wide_closest": 1, "wide_any": 1, "rounds_pick": 2 * tt.num_treelets,
                     "rounds_merge": 2 * tt.num_treelets, "treelet_meta": 2 * tt.num_treelets + rounds_run}
