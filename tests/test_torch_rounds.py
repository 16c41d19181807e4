"""The treelet driver's diagnostics and its second driver against the JAX
reference: ``treelet_intersect`` with ``nearest_first``, ``e_cap`` and
``sort_chunk``, ``treelet_intersect_rounds`` (closest and any hit), and
``treelet_layout_stats``. The cases port tests/test_treelets.py's
(nearest_first, the stats path) to the reference's interpret-mode calls.

The port here runs K3's plain version; the reference runs its Pallas kernel
in interpret mode (``interpret=True, sublanes=8``) on the same soup and
rays. Closest hit: the hit masks and prim ids are equal, t and uv equal to
within 1e-5 relative: XLA's CPU backend contracts the Möller–Trumbore
multiply-adds into fused multiply-adds, the port (like its kernel, built
with ``--fmad=false``) rounds each operation, so about half the hits differ
in the last bits of t (up to ~2e-6 relative measured: cancellation in the
dot products magnifies the one-rounding difference). Any hit: the hit masks
are equal (which triangle blocks first depends on traversal order, and
any-hit callers read only the mask).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_native
from raytracer3_tpu.ops import treelets as jtreelets
from raytracer3_tpu_torch.ops import treelets as ttreelets
from torch_threads import _one_torch_thread  # noqa: F401 (autouse: torch on one thread)

N = 8 * 128 * 3 + 17  # three segments and a ragged tail at sublanes=8


@pytest.fixture(autouse=True, scope="module")
def _reference_native_loaded():
    # The reference's table builders reach its native library, which other
    # test workers may be writing at this moment (tests/reference_native.py).
    reference_native.load()


def _soup(n, seed=0, spread=10.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return c, c + rng.normal(0, size, (n, 3)).astype(np.float32), c + rng.normal(0, size, (n, 3)).astype(np.float32)


def _rays(n, seed=33, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def soup():
    jtt = jtreelets.build_treelets_host(*_soup(900), leaf_size=4, width=8, max_tris=128)
    o, d = _rays(N)
    tmax = np.random.default_rng(35).uniform(1.0, 30.0, N).astype(np.float32)
    return jtt, ttreelets.tables_to_device(jtt, "cpu"), o, d, tmax


def _assert_same_hits(ref, got, any_hit):
    h = got.hit.numpy()
    np.testing.assert_array_equal(h, np.asarray(ref.hit))
    assert 50 < h.sum() < N
    if any_hit:
        return
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(ref.prim_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(ref.uv), rtol=1e-5, atol=1e-5)


CASES = {
    "nearest_first": dict(nearest_first=True, step_cull=True),
    "nearest_first_any": dict(nearest_first=True, step_cull=True, any_hit=True),
    "e_cap": dict(e_cap=2, step_cull=True),
    "sort_chunk": dict(sort_chunk=8),
    "sort_chunk_any": dict(sort_chunk=32, any_hit=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_driver_options_match_interpret_reference(soup, case):
    jtt, ttt, o, d, tmax = soup
    kw = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("any_hit"):
        jkw["t_max"], tkw["t_max"] = jnp.asarray(tmax), torch.from_numpy(tmax)
    if "e_cap" in kw:
        jkw["e_cap"] = jnp.int32(kw["e_cap"])  # a traced scalar in the reference
    ref = jtreelets.treelet_intersect(jtt, jnp.asarray(o), jnp.asarray(d), interpret=True, sublanes=8, **jkw)
    got = ttreelets.treelet_intersect(ttt, torch.from_numpy(o), torch.from_numpy(d), sublanes=8, **tkw)
    _assert_same_hits(ref, got, kw.get("any_hit", False))


def test_e_cap_drops_hits_and_stats_rows_sum_phases(soup):
    _, ttt, o, d, _ = soup
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    full = ttreelets.treelet_intersect(ttt, o, d, sublanes=8)
    capped = ttreelets.treelet_intersect(ttt, o, d, sublanes=8, e_cap=0)
    assert full.hit.sum() > 100 and not capped.hit.any()  # e_cap 0: every step skipped
    hit, rows = ttreelets.treelet_intersect(ttt, o, d, sublanes=8, stats=True)
    assert torch.equal(hit.t, full.t) and rows.shape == (4, 8) and rows.dtype == torch.int32
    assert (rows[:, 5:] == 0).all() and (rows[:, 0] >= rows[:, 4]).all()
    nf, nf_rows = ttreelets.treelet_intersect(ttt, o, d, sublanes=8, stats=True, nearest_first=True)
    assert torch.equal(nf.hit, full.hit) and nf_rows.shape == rows.shape
    # The two phases' rows are summed; the last sorted segment holds only
    # the padding and the rays that want no treelet.
    assert (nf_rows[:3, 0] > 0).all() and (nf_rows[:, 5:] == 0).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_rounds_match_interpret_reference(soup, any_hit):
    jtt, ttt, o, d, tmax = soup
    jkw = dict(any_hit=True, t_max=jnp.asarray(tmax)) if any_hit else {}
    tkw = dict(any_hit=True, t_max=torch.from_numpy(tmax)) if any_hit else {}
    ref = jtreelets.treelet_intersect_rounds(jtt, jnp.asarray(o), jnp.asarray(d), interpret=True, sublanes=8,
                                             **jkw)
    got, counts, rounds = ttreelets.treelet_intersect_rounds(
        ttt, torch.from_numpy(o), torch.from_numpy(d), sublanes=8, stats=True, return_rounds=True, **tkw)
    _assert_same_hits(ref, got, any_hit)
    assert 2 <= rounds <= ttt.num_treelets
    # A ray walks its segment's treelets each round (one group per segment
    # at sublanes=8), so its steps are at least the rounds it took part in.
    assert counts.shape == (N, 5) and counts[:, 4].max() >= rounds
    # Against the single pass: the same closest hits.
    single = ttreelets.treelet_intersect(ttt, torch.from_numpy(o), torch.from_numpy(d), sublanes=8, **tkw)
    assert torch.equal(single.hit, got.hit)


def test_rounds_max_rounds_stops_early(soup):
    _, ttt, o, d, _ = soup
    one = ttreelets.treelet_intersect_rounds(ttt, torch.from_numpy(o), torch.from_numpy(d), sublanes=8, max_rounds=1,
                                             return_rounds=True)
    full = ttreelets.treelet_intersect_rounds(ttt, torch.from_numpy(o), torch.from_numpy(d), sublanes=8)
    assert one[1] == 1 and one[0].hit.sum() < full.hit.sum()


def test_layout_stats_match_reference(soup):
    jtt, ttt, o, d, tmax = soup
    ref = jtreelets.treelet_layout_stats(jtt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), sublanes=8)
    got = ttreelets.treelet_layout_stats(ttt, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
                                         sublanes=8)
    assert set(got) == set(ref)
    for k in ("rays", "segments", "cand_max", "union_max", "steps"):
        assert got[k] == int(np.asarray(ref[k])), k
    for k in ("cand_mean", "union_mean"):
        assert got[k] == pytest.approx(float(np.asarray(ref[k])), rel=1e-6), k


def test_bits_words_round_trip_bit_31():
    bits = torch.zeros((3, 64), dtype=torch.bool)
    bits[0, 31] = True
    bits[1, [0, 31, 32, 63]] = True
    bits[2] = True
    words = ttreelets._bits_to_words(bits)
    assert words.dtype == torch.int32 and words[0, 0] == -(2**31) and words[2, 1] == -1
    assert torch.equal(ttreelets._words_to_bits(words, 64), bits)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jtreelets._bits_to_words(jnp.asarray(bits.numpy()))))
