"""LBVH build on tensors (port of ``raytracer3_tpu/ops/bvh.py``): Morton
codes → stable sort → Karras hierarchy → bottom-up AABB fit, on the device
of the input.

Layout (T triangles → T-1 internal nodes, T leaves):
  node_min/node_max: [2T-1, 3] f32 boxes, internal nodes first ([0, T-1)),
                     leaves at [T-1, 2T-1).
  node_left/node_right: [T-1] int32 child pointers into the node index space.
  leaf_tri: [T] int32 primitive index per leaf (Morton order).

The tables equal the reference's bit for bit. The Morton codes and the
stable ``argsort`` are PyTorch on either device (elementwise work and a
sort, which the reference also leaves outside its loops). On a CUDA tensor
``build_lbvh_aabbs`` then launches kernel A (``lbvh_topology_kernel``, the
reference's three ``while_loop``s as per-thread loops) and kernel B
(``lbvh_fit_kernel``, the bottom-up fit by arrival counters) of
``csrc/oracle_bvh.cu``, with no host read, so it can run inside a captured
CUDA graph. On a CPU tensor it runs the plain version,
``build_lbvh_aabbs_plain``: each ``while_loop`` an eager loop that reads
that flag from the device once a turn (``LOOP_TURNS`` counts them).
Integer work is int64 (codes are 30 bits, so every XOR stays
non-negative); ``jax.lax.clz`` is ``_clz32``, an exact count on integers.
Boxes take the reference's ``jnp.minimum``/``jnp.maximum``
(``ieee_minimum``/``ieee_maximum``: NaN propagates, -0 is below +0), which
``torch.minimum`` matches only up to which zero it keeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer3_tpu_torch.ops import mathx

# Turns of the plain build's eager loops, last plain build (the reference's
# while_loops).
LOOP_TURNS = {"range": 0, "length": 0, "split": 0, "fit": 0}

_M32 = 0xFFFFFFFF


class BVH(NamedTuple):
    node_min: torch.Tensor  # [2T-1, 3] f32
    node_max: torch.Tensor  # [2T-1, 3] f32
    node_left: torch.Tensor  # [T-1] int32
    node_right: torch.Tensor  # [T-1] int32
    leaf_tri: torch.Tensor  # [T] int32 primitive id per leaf

    @property
    def num_tris(self) -> int:
        return self.leaf_tri.shape[0]

    @property
    def num_internal(self) -> int:
        return self.num_tris - 1

    @property
    def root(self) -> int:
        return 0


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of int64 ``x`` (32 for 0): a binary
    search on masks, exact on integers."""
    x = x & _M32
    n = torch.zeros_like(x)
    for bits in (16, 8, 4, 2, 1):
        mask = (_M32 << (32 - bits)) & _M32
        zero = (x & mask) == 0
        n = n + zero.to(x.dtype) * bits
        x = torch.where(zero, (x << bits) & _M32, x)
    return n + (x == 0).to(x.dtype)


def _make_delta(codes_sorted: torch.Tensor):
    """Common-prefix length δ(i, j) over the 64-bit keys (code << 32 |
    sorted index), Karras's duplicate-code tie-break; -1 where j is out of
    range."""
    n = codes_sorted.shape[0]

    def delta(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        valid = (j >= 0) & (j < n)
        j_safe = j.clamp(0, n - 1)
        cx = codes_sorted[i] ^ codes_sorted[j_safe]
        ix = (i & _M32) ^ (j_safe & _M32)
        d = torch.where(cx != 0, _clz32(cx), 32 + _clz32(ix))
        return torch.where(valid, d, -1)

    return delta


_NAN = float("nan")


def ieee_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE 754-2019 minimum, ``jnp.minimum``'s rule on every device: NaN
    where either is NaN (the canonical quiet NaN), -0 below +0.
    ``torch.minimum`` keeps whichever zero its vector lane gives."""
    m = torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, m)


def ieee_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE 754-2019 maximum (``jnp.maximum``): NaN propagates, +0 above -0."""
    m = torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, m)


def build_lbvh(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor) -> BVH:
    """LBVH over triangles given as three [T, 3] vertex tensors."""
    tri_min = ieee_minimum(ieee_minimum(v0, v1), v2)
    tri_max = ieee_maximum(ieee_maximum(v0, v1), v2)
    return build_lbvh_aabbs(tri_min, tri_max)


def _sorted_codes(tri_min: torch.Tensor, tri_max: torch.Tensor):
    """(stable Morton order [T] int64, the codes in that order [T] int64)."""
    if tri_min.shape[0] < 2:
        raise ValueError("LBVH needs at least 2 primitives")
    centroid = (tri_min + tri_max) * 0.5
    scene_min = tri_min.amin(dim=0)
    scene_max = tri_max.amax(dim=0)
    extent = torch.clamp_min(scene_max - scene_min, 1e-9)
    codes = mathx.morton3d((centroid - scene_min) / extent)  # [T] int64, 30 bits
    order = torch.argsort(codes, stable=True)
    return order, codes[order]


def build_lbvh_aabbs(tri_min: torch.Tensor, tri_max: torch.Tensor) -> BVH:
    """LBVH over primitives given by their boxes ([P, 3] min / max);
    ``leaf_tri`` then holds primitive indices. A CUDA tensor launches
    kernels A and B (counted in ``traverse_kernel.LAUNCHES`` as
    ``lbvh_topology`` and ``lbvh_fit``) or raises; a CPU tensor runs
    ``build_lbvh_aabbs_plain``."""
    dev = tri_min.device
    if dev.type == "cpu":
        return build_lbvh_aabbs_plain(tri_min, tri_max)
    if dev.type != "cuda":
        raise ValueError(f"build_lbvh_aabbs runs on cpu or cuda tensors, not {dev}")
    from raytracer3_tpu_torch.ops import oracle_kernels as ok
    from raytracer3_tpu_torch.ops import traverse_kernel as tk

    order, codes_sorted = _sorted_codes(tri_min, tri_max)
    lib = ok.load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        left, right, parent = ok.lbvh_topology(lib, codes_sorted, stream)
        node_min, node_max = unfitted_boxes(tri_min[order].float(), tri_max[order].float())
        ok.lbvh_fit(lib, left, right, parent, node_min, node_max, stream)
    tk.LAUNCHES["lbvh_topology"] += 1
    tk.LAUNCHES["lbvh_fit"] += 1
    return BVH(node_min=node_min, node_max=node_max, node_left=left, node_right=right,
               leaf_tri=order.to(torch.int32))


def build_lbvh_aabbs_plain(tri_min: torch.Tensor, tri_max: torch.Tensor) -> BVH:
    """The plain version of ``build_lbvh_aabbs`` on any device: the
    reference's loops (``lbvh_topology_plain``, ``lbvh_fit_plain``), each an
    eager loop over all nodes that reads its flag on the host once a turn."""
    order, codes_sorted = _sorted_codes(tri_min, tri_max)
    left, right = lbvh_topology_plain(codes_sorted)
    node_min, node_max = lbvh_fit_plain(left, right, tri_min[order], tri_max[order])
    return BVH(node_min=node_min, node_max=node_max, node_left=left, node_right=right,
               leaf_tri=order.to(torch.int32))


def lbvh_topology_plain(codes_sorted: torch.Tensor, counts=None):
    """Karras topology of the sorted int64 codes [T] → (left, right) [T-1]
    int32, kernel A's plain version. ``counts``, an int64 [T-1] tensor,
    gets each node's δ evaluations added (kernel A's work, for its bound)."""
    t = codes_sorted.shape[0]
    dev = codes_sorted.device
    delta = _make_delta(codes_sorted)
    tally = (lambda live: counts.add_(live.long())) if counts is not None else (lambda live: None)

    i = torch.arange(t - 1, dtype=torch.int64, device=dev)
    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)
    tally(torch.full((t - 1,), 3, dtype=torch.int64, device=dev))

    # Upper bound on the range length: double lmax while δ(i, i+lmax·d) > δmin.
    lmax = torch.full((t - 1,), 2, dtype=torch.int64, device=dev)
    growing = torch.ones(t - 1, dtype=torch.bool, device=dev)
    turns = 0
    while bool(growing.any()):
        tally(growing)
        growing = growing & (delta(i, i + lmax * d) > delta_min)
        lmax = torch.where(growing, lmax * 2, lmax)
        turns += 1
    LOOP_TURNS["range"] = turns

    # Binary descent to the exact range length l < lmax.
    l = torch.zeros(t - 1, dtype=torch.int64, device=dev)
    step = lmax // 2
    turns = 0
    while bool((step >= 1).any()):
        tally(step >= 1)
        ok = delta(i, i + (l + step) * d) > delta_min
        l = torch.where(ok & (step >= 1), l + step, l)
        step = step // 2
        turns += 1
    LOOP_TURNS["length"] = turns
    j = i + l * d  # the other end of the range

    # Split: the largest s with δ(i, i+(s+t)·d) > δ(i, j), t = ceil(l/2^k).
    delta_node = delta(i, j)
    tally(torch.ones(t - 1, dtype=torch.int64, device=dev))
    s = torch.zeros(t - 1, dtype=torch.int64, device=dev)
    div = torch.full((t - 1,), 2, dtype=torch.int64, device=dev)
    t_step = (l + 1) // 2
    turns = 0
    while bool((t_step >= 1).any()):
        tally(t_step >= 1)
        ok = (t_step >= 1) & (delta(i, i + (s + t_step) * d) > delta_node)
        s = torch.where(ok, s + t_step, s)
        div = div * 2
        nxt = (l + div - 1) // div
        t_step = torch.where(t_step <= 1, 0, nxt)  # the final t=1 probe is done
        turns += 1
    LOOP_TURNS["split"] = turns
    gamma = i + s * d + torch.clamp_max(d, 0)

    rng_lo = torch.minimum(i, j)
    rng_hi = torch.maximum(i, j)
    # A child is a leaf when its range is one element; leaf k is node (T-1)+k.
    left = torch.where(rng_lo == gamma, gamma + (t - 1), gamma).to(torch.int32)
    right = torch.where(rng_hi == gamma + 1, gamma + 1 + (t - 1), gamma + 1).to(torch.int32)
    return left, right


def unfitted_boxes(leaf_min: torch.Tensor, leaf_max: torch.Tensor):
    """The fit's starting tables [2T-1, 3] (contiguous): internal rows
    [0, T-1) empty (+inf min, -inf max), then the leaves' boxes [T, 3] in
    Morton order."""
    t = leaf_min.shape[0]
    dev = leaf_min.device
    return (torch.cat([torch.full((t - 1, 3), float("inf"), device=dev), leaf_min]).contiguous(),
            torch.cat([torch.full((t - 1, 3), float("-inf"), device=dev), leaf_max]).contiguous())


def lbvh_fit_plain(left: torch.Tensor, right: torch.Tensor, leaf_min: torch.Tensor, leaf_max: torch.Tensor):
    """Bottom-up fit → (node_min, node_max) [2T-1, 3], kernel B's plain
    version: pull child boxes into parents until no bit moves (a NaN box
    settles too: the canonical NaN keeps its bits)."""
    t = leaf_min.shape[0]
    node_min, node_max = unfitted_boxes(leaf_min, leaf_max)
    li, ri = left.long(), right.long()
    changed = True
    turns = 0
    while changed:
        new_min = ieee_minimum(node_min[li], node_min[ri])
        new_max = ieee_maximum(node_max[li], node_max[ri])
        changed = bool((new_min.view(torch.int32) != node_min[: t - 1].view(torch.int32)).any()
                       | (new_max.view(torch.int32) != node_max[: t - 1].view(torch.int32)).any())
        node_min = torch.cat([new_min, node_min[t - 1:]])
        node_max = torch.cat([new_max, node_max[t - 1:]])
        turns += 1
    LOOP_TURNS["fit"] = turns
    return node_min, node_max


def validate_bvh_host(bvh) -> None:
    """Host-side structural check (tests): every leaf reachable exactly
    once, parent boxes contain their children."""
    t = len(bvh.leaf_tri)
    left, right, nmin, nmax, leaf_tri = (
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (bvh.node_left, bvh.node_right, bvh.node_min, bvh.node_max, bvh.leaf_tri))

    seen = np.zeros(t, dtype=int)
    stack = [0]
    visited_internal = set()
    while stack:
        node = stack.pop()
        if node >= t - 1:
            seen[node - (t - 1)] += 1
            continue
        assert node not in visited_internal, f"cycle at internal node {node}"
        visited_internal.add(node)
        for c in (left[node], right[node]):
            assert (nmin[node] <= nmin[c] + 1e-6).all(), "parent min violated"
            assert (nmax[node] >= nmax[c] - 1e-6).all(), "parent max violated"
            stack.append(int(c))
    assert (seen == 1).all(), f"leaves not covered exactly once: {seen}"
    assert len(np.unique(leaf_tri)) == t
