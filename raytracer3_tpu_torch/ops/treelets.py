"""Treelet-binned traversal for large scenes: the segment-grid driver of K3
(port of ``raytracer3_tpu/ops/treelets.py``).

The scene's triangles are cut into K treelets (an SAH or centroid-median
partition), each with its own wide cluster BVH; the tables are padded to a
common size and stacked. A trace:

1. Dense [N, K] slab tests against the treelet boxes give each ray its
   candidate treelets and entry distances.
2. Rays are coherence-sorted once (nearest candidate treelet, direction
   octant, Morton code of the entry point) into segments of
   ``sublanes·128`` rays (primaries come tile-ordered and skip the sort).
3. Per segment, the union of its rays' candidates, near-first, becomes the
   step list ``seg_list [S, E]`` with each step's entry distance
   ``seg_entry`` and the bitmask of its ray groups that want the treelet
   ``seg_gmask``. One launch of K3 (``traverse_kernel.packet_intersect_segments``)
   walks every segment's steps in order, carrying each ray's best t from
   step to step.
4. Results return to the caller's ray order; misses read as background.

The reference's diagnostics come along: ``nearest_first`` (two launches:
each ray's nearest treelet, then the rest under a tightened cap),
``e_cap``, ``sort_chunk``, ``stats`` (per-segment rows of K5's counts), the
second driver ``treelet_intersect_rounds`` (per-ray nearest-first rounds
over treelet-pure segments, one K3 launch a round) and the driver-only
``treelet_layout_stats``.

The metadata is the reference's to the bit (tests/test_torch_treelets.py):
the ``(1 - 1e-4)``/``1e-5`` nudges round as float32 constants, sentinel slots
repeat the last real id with a zero group mask, and the stable sort keeps
the reference's tie order. TPU mechanics are not ported: the VMEM auto-fit,
``SEG_LAUNCH_CHUNK`` (one launch covers every segment here), and the
``half_leaf``/``bit_loop``/``rank_push``/``div_free``/``bw_leaf``/
``tables_hbm``/``vmem_limit`` flags. The slab reductions run densely over
ray chunks instead of the reference's ``lax.map`` (same results).

On CUDA tensors ``treelet_intersect`` and ``segment_launch`` take the
driver's hand-written passes (``ops/treelet_driver_kernel`` →
``csrc/treelet_driver.cu``): the key pass for steps 1-2 before PyTorch's
stable argsort, the metadata pass for step 3 (with the sort's gathers and
the padding), to the bit what the PyTorch passes here give, which every CPU
call takes and which are their plain version. Each round of
``treelet_intersect_rounds`` takes the same launch pass (on CUDA tensors
the metadata pass). Those passes hold at most
``treelet_driver_kernel.MAX_TREELETS`` (256) treelets; a larger table
raises on CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import cluster_bvh as cb_mod
from raytracer3_tpu_torch.ops import mathx
from raytracer3_tpu_torch.ops import oracle_kernels as ok
from raytracer3_tpu_torch.ops import traverse_kernel as tk
from raytracer3_tpu_torch.ops import treelet_driver_kernel as tdk
from raytracer3_tpu_torch.ops.backend import TraceBackend
from raytracer3_tpu_torch.ops.intersect import Hit

_BG = mathx.BACKGROUND_DEPTH
# Group caps of the reference's production backend: presorted primaries use
# at most 32 groups per segment, the sorted launches 128.
MAX_GROUPS_PRIMARY = 32
MAX_GROUPS_SORTED = 128
# Rays per chunk of the dense slab reductions (keeps the [N, K, 3]
# temporaries small at the tail launch's 2·W·H·spp lanes).
_SLAB_CHUNK = 1 << 21


class TreeletTables(NamedTuple):
    """Per-treelet packed tables, padded to a common size and stacked."""

    node_tables: object  # [K, Mt, row_len] f32 (wide-node rows, local ids)
    cluster_tables: object  # [K, Ct, lanes] f32 (kernel layout, global tids)
    aabb: object  # [K, 8] f32 rows: (min xyz | max xyz | pad)
    leaf_size: int
    width: int
    depth: int  # max treelet depth (the reference's stack sizing)
    num_treelets: int
    max_nodes: int
    max_clusters: int
    leaf_aabb: bool = False  # cluster rows carry AABBs in lanes [10L, 10L+6)
    # Worst-case traversal stack over the treelets (``stack_need_host``);
    # 0 = not known.
    stack_need: int = 0


def _median_partition(centroids: np.ndarray, max_items: int) -> list[np.ndarray]:
    """Recursive largest-axis centroid-median split → balanced index groups
    of ≤ max_items."""
    parts = []

    def rec(idx):
        if idx.size <= max_items:
            parts.append(idx)
            return
        c = centroids[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = idx.size // 2
        rec(idx[order[:half]])
        rec(idx[order[half:]])

    rec(np.arange(centroids.shape[0], dtype=np.int64))
    return parts


def _sah_partition(
    centroids: np.ndarray, tri_min: np.ndarray, tri_max: np.ndarray,
    max_items: int, balance: int = 3,
) -> list[np.ndarray]:
    """Surface-area-minimizing cut: recursive sweep over the three centroid
    orders picking the split that minimizes SA(left)·n_l + SA(right)·n_r,
    with cuts confined to [1/(b+1), b/(b+1)] of the range."""
    parts = []

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0)
        return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2]

    def rec(idx):
        if idx.size <= max_items:
            parts.append(idx)
            return
        best = None
        m = idx.size
        cand = np.arange(max(1, m // (balance + 1)), min(m, balance * m // (balance + 1)))
        for ax in range(3):
            order = np.argsort(centroids[idx, ax], kind="stable")
            si = idx[order]
            lo_c = np.minimum.accumulate(tri_min[si], axis=0)
            hi_c = np.maximum.accumulate(tri_max[si], axis=0)
            lo_r = np.minimum.accumulate(tri_min[si][::-1], axis=0)[::-1]
            hi_r = np.maximum.accumulate(tri_max[si][::-1], axis=0)[::-1]
            cost = sa(lo_c, hi_c)[cand - 1] * cand + sa(lo_r, hi_r)[cand] * (m - cand)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (cost[j], si, int(cand[j]))
        _, si, cut = best
        rec(si[:cut])
        rec(si[cut:])

    rec(np.arange(centroids.shape[0], dtype=np.int64))
    return parts


def build_treelets_host(
    v0, v1, v2, leaf_size: int = 24, width: int = 16, max_tris: int = 98304,
    partition: str = "sah", cluster_mode: str = "median", split_budget: float = 0.0,
) -> TreeletTables:
    """Partition triangles into treelets and build each treelet's wide
    cluster BVH; numpy in, numpy tables out.

    partition: "sah" (overlap-minimizing cut) or "median"; ``split_budget``
    as in ``cluster_bvh.build_cluster_bvh_host``."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    cent = (v0 + v1 + v2) / 3.0
    if partition == "sah":
        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)
        parts = _sah_partition(cent, tri_min, tri_max, max_tris)
    else:
        parts = _median_partition(cent, max_tris)

    nodes, clusters, aabbs, depth, need = [], [], [], 1, 1
    for idx in parts:
        cb = cb_mod.build_cluster_bvh_host(
            v0[idx], v1[idx], v2[idx], leaf_size, width=width, cluster_mode=cluster_mode,
            split_budget=split_budget,
        )
        pt = tk.pack_tables_host(cb)
        ct = np.array(pt.cluster_table)
        # Local triangle ids → global (float rows; ids exact below 2^24).
        ls = pt.leaf_size
        local = ct[:, 9 * ls : 10 * ls].astype(np.int64)
        remapped = np.where(local >= 0, idx[np.clip(local, 0, idx.size - 1)], -1)
        ct[:, 9 * ls : 10 * ls] = remapped.astype(np.float32)
        nodes.append(np.asarray(pt.node_table))
        clusters.append(ct)
        lo = np.minimum(np.minimum(v0[idx].min(0), v1[idx].min(0)), v2[idx].min(0))
        hi = np.maximum(np.maximum(v0[idx].max(0), v1[idx].max(0)), v2[idx].max(0))
        aabbs.append(np.concatenate([lo, hi]))
        depth = max(depth, pt.depth)
        need = max(need, pt.stack_need)

    k = len(parts)
    mt = max(n.shape[0] for n in nodes)
    ctm = max(c.shape[0] for c in clusters)
    row_len = nodes[0].shape[1]
    lanes = clusters[0].shape[1]
    node_t = np.zeros((k, mt, row_len), np.float32)
    clus_t = np.zeros((k, ctm, lanes), np.float32)
    # Padding cluster rows: degenerate triangles, tid -1, inverted AABBs.
    tid0 = 9 * leaf_size
    clus_t[:, :, tid0 : tid0 + leaf_size] = -1.0
    ab0 = 10 * leaf_size
    clus_t[:, :, ab0 : ab0 + 3] = 1e30
    clus_t[:, :, ab0 + 3 : ab0 + 6] = -1e30
    # Padding node rows: every slot an inverted box with empty code -1.
    node_t[:, :, 0 : 3 * width] = 1e30
    node_t[:, :, 3 * width : 6 * width] = -1e30
    node_t[:, :, 6 * width : 7 * width] = -1.0
    for i, (nd, c) in enumerate(zip(nodes, clusters)):
        node_t[i, : nd.shape[0]] = nd
        clus_t[i, : c.shape[0]] = c
    aabb = np.zeros((k, 8), np.float32)
    aabb[:, :6] = np.stack(aabbs).astype(np.float32)
    return TreeletTables(
        node_tables=node_t, cluster_tables=clus_t, aabb=aabb, leaf_size=leaf_size,
        width=width, depth=depth, num_treelets=k, max_nodes=mt, max_clusters=ctm,
        leaf_aabb=True, stack_need=need,
    )


def stack_need_host(node_tables, width: int) -> int:
    """The most ``traverse_kernel.tree_stack_need`` of stacked treelet node
    tables [K, Mt, row] (numpy or a tensor): one traversal walks one
    treelet at a time on the same stack."""
    nt = node_tables.detach().cpu().numpy() if isinstance(node_tables, torch.Tensor) else np.asarray(node_tables)
    return max(tk.tree_stack_need(nt[k][:, 6 * width : 7 * width]) for k in range(nt.shape[0]))


def tables_to_device(tt, device) -> TreeletTables:
    """Upload the three tables of ``tt`` (the port's ``TreeletTables``, or
    the reference's with numpy or array fields) to ``device``; the
    reference's carry no stack need, so it is computed here first."""

    def up(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.array(a, np.float32), device=device)

    need = getattr(tt, "stack_need", 0) or stack_need_host(tt.node_tables, int(tt.width))
    return TreeletTables(
        node_tables=up(tt.node_tables), cluster_tables=up(tt.cluster_tables), aabb=up(tt.aabb),
        leaf_size=int(tt.leaf_size), width=int(tt.width), depth=int(tt.depth),
        num_treelets=int(tt.num_treelets), max_nodes=int(tt.max_nodes), max_clusters=int(tt.max_clusters),
        leaf_aabb=bool(tt.leaf_aabb), stack_need=int(need),
    )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)


def _treelet_slabs(aabb, o, inv_d, t_min, t_cap):
    """Dense [N, K] slab tests vs treelet AABBs → (entry_t, hit)."""
    lo = aabb[None, :, 0:3]
    hi = aabb[None, :, 3:6]
    t0 = (lo - o[:, None, :]) * inv_d[:, None, :]
    t1 = (hi - o[:, None, :]) * inv_d[:, None, :]
    tn = torch.clamp_min(torch.amax(torch.minimum(t0, t1), dim=-1), t_min)
    tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), t_cap[:, None])
    return tn, tn <= tf


def _slab_chunks(aabb, o, d, cap, t_min, reduce, rows: int = _SLAB_CHUNK) -> list:
    """``reduce(r, entry_t, hit)`` of the slab tests (``_treelet_slabs``) of
    each chunk ``r`` (a slice) of ``rows`` rays, each of its outputs
    concatenated over the chunks: the [rows, K, 3] temporaries stay small at
    14.7M-lane populations."""
    parts = [reduce(r, *_treelet_slabs(aabb, o[r], _inv_dir(d[r]), t_min, cap[r]))
             for r in (slice(s0, s0 + rows) for s0 in range(0, o.shape[0], rows))]
    return [torch.cat(x) for x in zip(*parts)]


def _slab_hits(aabb, o, d, cap, t_min) -> torch.Tensor:
    """[N, K] bool: the treelets whose boxes each ray enters within its cap."""
    return _slab_chunks(aabb, o, d, cap, t_min, lambda r, tn, hit: (hit,))[0]


def _entry_morton(o, d, near, lo, hi):
    """The 18-bit Morton code, in the box lo..hi, of each ray's point at its
    entry distance ``near`` (where that is finite; 1e30 elsewhere)."""
    pos = torch.where(torch.isfinite(near)[:, None], o + torch.clamp_min(near, 0.0)[:, None] * d, 1e30)
    norm = (pos - lo) / torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp(norm * 63.0, 0, 63).to(torch.int32)
    m = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for b in range(6):
        m = (
            m
            | (((q[:, 0] >> b) & 1) << (3 * b + 2))
            | (((q[:, 1] >> b) & 1) << (3 * b + 1))
            | (((q[:, 2] >> b) & 1) << (3 * b))
        )
    return m


def _seg_reduce(aabb, o, d, cap, *, t_min, p, groups, only_tid=None, exclude_tid=None):
    """Per-segment slab reductions: (seg_tn [S, K] min entry t over the
    rays that want each treelet, seg_any [S, K], gact [S, G, K] which ray
    groups want it). Dense over chunks of whole segments.

    only_tid [N] int32 keeps only that treelet in each ray's want (the
    nearest-first phase 1 and each round of the rounds driver);
    exclude_tid [N] drops it (phase 2)."""
    k = aabb.shape[0]
    tid = only_tid if only_tid is not None else exclude_tid
    cols = torch.arange(k, dtype=torch.int32, device=o.device)

    def reduce(r, tn, want):
        if tid is not None:
            sel = cols[None, :] == tid[r][:, None]
            want = want & (sel if only_tid is not None else ~sel)
        cs = want.shape[0] // p
        tn_m = torch.where(want, tn, torch.inf).reshape(cs, p, k)
        w = want.reshape(cs, p, k)
        return torch.amin(tn_m, dim=1), torch.any(w, dim=1), torch.any(w.reshape(cs, groups, p // groups, k), dim=2)

    return tuple(_slab_chunks(aabb, o, d, cap, t_min, reduce, rows=max(1, _SLAB_CHUNK // p) * p))


def _near_tid(aabb, o, d, cap, *, t_min, mask=None):
    """Per ray: (the nearest candidate's entry t, its treelet id, K where
    none; the candidates [N, K] bool). A candidate is a treelet whose box
    the ray enters within its cap and, given ``mask`` [N, K] bool, one the
    mask keeps. The sort key's first field, and the rounds driver's pick."""
    k = aabb.shape[0]

    def pick(r, tn, want):
        if mask is not None:
            want = want & mask[r]
        tn_m = torch.where(want, tn, torch.inf)
        near = torch.amin(tn_m, dim=1)
        return near, torch.where(torch.isfinite(near), torch.argmin(tn_m, dim=1).to(torch.int32), k), want

    return tuple(_slab_chunks(aabb, o, d, cap, t_min, pick))


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns → int32 (bit 31 wraps to the sign)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def segment_metadata(seg_tn, seg_any, gact, n_words: int, e_cap=None):
    """(seg_list [S, E] i32, seg_entry [S, E] f32, seg_gmask [S, E, W] i32):
    near-first candidate lists whose sentinel slots repeat the last real id
    with a zero group mask, each step's min entry distance nudged down so fp
    jitter between the slab test and the Möller parameter cannot cull a
    boundary hit (1e30 on sentinels), and the group bitmask words. Steps
    at or beyond ``e_cap`` (a diagnostic: it drops hits) get mask 0."""
    seg_key = torch.where(seg_any, seg_tn, torch.inf)
    seg_order = torch.argsort(seg_key, dim=1, stable=True).to(torch.int32)
    order_l = seg_order.long()
    sorted_key = torch.gather(seg_key, 1, order_l)
    seg_valid = torch.isfinite(sorted_key)
    length = seg_valid.sum(dim=1)
    last = torch.gather(seg_order, 1, torch.clamp_min(length - 1, 0)[:, None])
    seg_list = torch.where(seg_valid, seg_order, last)
    seg_entry = torch.where(seg_valid, sorted_key * (1.0 - 1e-4) - 1e-5, 1e30)

    groups = gact.shape[1]
    words = []
    for wd in range(n_words):
        lo, hi = 32 * wd, min(32 * (wd + 1), groups)
        shifts = torch.arange(hi - lo, dtype=torch.int64, device=gact.device)
        words.append((gact[:, lo:hi].to(torch.int64) << shifts[None, :, None]).sum(dim=1))
    gmask_k = _to_int32_bits(torch.stack(words, dim=-1))  # [S, K, W]
    seg_gmask = torch.gather(gmask_k, 1, order_l[:, :, None].expand(-1, -1, n_words))
    seg_gmask = torch.where(seg_valid[:, :, None], seg_gmask, 0)
    if e_cap is not None:
        slot = torch.arange(seg_gmask.shape[1], device=seg_gmask.device)[None, :, None]
        seg_gmask = torch.where(slot < e_cap, seg_gmask, 0)
    return seg_list.contiguous(), seg_entry.contiguous(), seg_gmask.contiguous()


class SegmentLaunch(NamedTuple):
    """K3's inputs for one trace, as the driver builds them (rays in
    segment order), plus what maps its output back to the caller's rays."""

    seg_list: torch.Tensor  # [S, E] int32
    seg_entry: torch.Tensor  # [S, E] f32
    seg_gmask: torch.Tensor  # [S, E, W] int32
    origins: torch.Tensor  # [S·p, 3]
    directions: torch.Tensor  # [S·p, 3]
    t_cap: torch.Tensor  # [S·p]
    anyhit_row: Optional[torch.Tensor]  # [S·p] f32 or None
    order: Optional[torch.Tensor]  # sorted position → padded input ray; None if unsorted
    n: int  # the caller's ray count
    kw: dict  # t_min, any_hit, step_cull, sublanes, max_groups

    def launch(self, tt: TreeletTables, fn=None, stats: bool = False):
        """Run K3 (``fn`` defaults to ``packet_intersect_segments``) →
        [4, S·p] rows in segment order; with ``stats`` its K5 form →
        (rows, int32 [S·p, 5] per-ray counts)."""
        fn = fn or tk.packet_intersect_segments
        extra = dict(stats=True) if stats else {}
        return fn(tt, self.seg_list, self.seg_entry, self.seg_gmask, self.origins,
                  self.directions, self.t_cap, anyhit_row=self.anyhit_row, **self.kw, **extra)


def _prepare(tt: TreeletTables, origins, directions, t_min, t_max, p: int, presorted: bool,
             anyhit_mask, step_cull: bool, sort_chunk: int, nearest_tid: bool = False):
    """Pad to whole segments, clamp caps to the scene exit (``step_cull``)
    and find the coherence sort's order (unless presorted or one treelet):
    returns (o, d, cap, anyhit row or None, all padded and in the caller's
    order; the order or None; and with ``nearest_tid`` each sorted slot's
    nearest treelet, else None), as ``_launch_for`` takes them.
    ``sort_chunk`` g > 1 sorts g-ray chunks by their smallest key and keeps
    each chunk contiguous."""
    n = origins.shape[0]
    n_pad = -(-n // p) * p
    o, d, cap = _pad_rays(origins, directions, t_max, n_pad)
    ah = None
    if anyhit_mask is not None:
        ah = torch.cat([anyhit_mask.to(torch.float32), cap.new_zeros((n_pad - n,))])

    sort = not presorted and tt.num_treelets > 1
    cap, key, tid0 = key_pass_plain(tt.aabb, o, d, cap, t_min=t_min, step_cull=step_cull, sort=sort)
    order = tid_s = None
    if sort:
        order = _sort_order(key, sort_chunk)
        if nearest_tid:
            tid_s = tid0[order]
    return o, d, cap, ah, order, tid_s


def _pad_rays(origins, directions, t_max, n_pad: int):
    """Rays [N, 3] and their caps ``t_max`` (a number, or per-ray [N])
    padded to ``n_pad`` lanes: (o, d [N_pad, 3], cap [N_pad] f32), the pad
    lanes at origin 1e30, direction 1 and cap 0 (parked)."""
    n, dev = origins.shape[0], origins.device
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        t_cap = t_max.to(torch.float32)
    else:
        t_cap = torch.full((n,), float(t_max), dtype=torch.float32, device=dev)
    pad = n_pad - n
    o = torch.cat([origins, torch.full((pad, 3), 1e30, dtype=torch.float32, device=dev)])
    d = torch.cat([directions, torch.ones((pad, 3), dtype=torch.float32, device=dev)])
    return o, d, torch.cat([t_cap, torch.zeros((pad,), dtype=torch.float32, device=dev)])


def key_pass_plain(aabb, o, d, cap, *, t_min: float, step_cull: bool, sort: bool):
    """The plain version of ``treelet_driver_kernel.key_pass`` on padded
    rays o, d [N_pad, 3] and caps [N_pad]: (the caps, clamped to the
    scene-exit distance under ``step_cull``; with ``sort`` the sort key
    ``(tid0 << 21) | (octant << 18) | morton`` and the nearest candidate
    treelet tid0, K where none; else None, None)."""
    lo_s = aabb[:, 0:3].amin(dim=0)
    hi_s = aabb[:, 3:6].amax(dim=0)
    if step_cull:
        # Scene-exit caps: nothing lies beyond a ray's exit from the scene
        # box (padded up so rounding keeps boundary hits). Finite caps let
        # the kernel's per-step cull fire; misses become background later.
        inv_d = _inv_dir(d)
        t0g = (lo_s[None] - o) * inv_d
        t1g = (hi_s[None] - o) * inv_d
        tn_g = torch.clamp_min(torch.amax(torch.minimum(t0g, t1g), dim=1), t_min)
        tf_g = torch.amin(torch.maximum(t0g, t1g), dim=1)
        exit_t = tf_g * (1.0 + 1e-4) + 1e-5
        cap = torch.where(tn_g <= exit_t, torch.minimum(cap, exit_t), 0.0)
    if not sort:
        return cap, None, None
    near, tid0, _ = _near_tid(aabb, o, d, cap, t_min=t_min)
    octant = (
        (d[:, 0] >= 0).to(torch.int32)
        + 2 * (d[:, 1] >= 0).to(torch.int32)
        + 4 * (d[:, 2] >= 0).to(torch.int32)
    )
    return cap, (tid0 << 21) | (octant << 18) | _entry_morton(o, d, near, lo_s, hi_s), tid0


def _sort_order(key: torch.Tensor, sort_chunk: int) -> torch.Tensor:
    """The coherence sort's order of the padded rays by their keys; with
    ``sort_chunk`` g > 1, g-ray chunks by their smallest key, each kept
    contiguous."""
    if sort_chunk > 1:
        g = sort_chunk
        cperm = torch.argsort(key.reshape(-1, g).amin(dim=1), stable=True)
        return (cperm[:, None] * g + torch.arange(g, device=key.device)[None, :]).reshape(-1)
    return torch.argsort(key, stable=True)


def _prepare_kernels(lib, tt: TreeletTables, origins, directions, t_min, t_max, p: int, presorted: bool,
                     anyhit_mask, step_cull: bool, sort_chunk: int, nearest_tid: bool = False):
    """``_prepare`` through the key pass of ``lib`` (``csrc/treelet_driver.cu``)
    and PyTorch's argsort: the same but that the rays and any-hit mask are
    the caller's as given (the metadata pass pads them)."""
    sort = not presorted and tt.num_treelets > 1
    cap, key, tid0 = tdk.key_pass(lib, tt.aabb, origins, directions, t_max, p=p, t_min=t_min, step_cull=step_cull,
                                  sort=sort, nearest_tid=nearest_tid)
    order = _sort_order(key, sort_chunk) if sort else None
    return origins, directions, cap, anyhit_mask, order, None if tid0 is None else tid0[order]


def _kernel_passes(lib):
    """The driver's passes through ``lib``, a build of
    ``csrc/treelet_driver.cu``, as (prepare, launch_for)."""
    return functools.partial(_prepare_kernels, lib), functools.partial(_launch_for_kernels, lib)


def _passes(origins: torch.Tensor):
    """The driver's passes a trace of ``origins`` takes, as (prepare,
    launch_for): the nvcc build's on CUDA tensors, the plain PyTorch passes
    elsewhere."""
    if origins.device.type == "cuda":
        return _kernel_passes(tdk.load_kernels())
    return _prepare, _launch_for


def segment_launch(
    tt: TreeletTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 512, presorted: bool = False,
    anyhit_mask=None, step_cull: bool = False, max_groups: int = 32,
    sort_chunk: int = 1, e_cap=None,
) -> SegmentLaunch:
    """The driver up to the kernel: pad, scene-exit caps (``step_cull``),
    coherence sort, slab reductions and segment metadata."""
    p, group_rays, n_words = tk._segment_groups(sublanes, max_groups)
    prepare, launch_for = _passes(origins)
    o, d, cap, ah, order, _ = prepare(tt, origins, directions, t_min, t_max, p, presorted, anyhit_mask,
                                      step_cull, sort_chunk)
    return launch_for(tt, o, d, cap, ah, order, origins.shape[0], p, group_rays, n_words, e_cap,
                      dict(t_min=t_min, any_hit=any_hit, step_cull=step_cull, sublanes=sublanes,
                           max_groups=max_groups))


def _launch_for(tt, o, d, cap, ah, order, n, p, group_rays, n_words, e_cap, kw,
                only_tid=None, exclude_tid=None) -> SegmentLaunch:
    """The padded rays, caps and any-hit row in the caller's order, taken
    in ``order`` (as they are without one), and their segment metadata →
    their ``SegmentLaunch``. ``only_tid`` / ``exclude_tid`` [N_pad] are in
    sorted order."""
    if order is not None:
        o, d, cap = o[order], d[order], cap[order]
        if ah is not None:
            ah = ah[order]
    meta = _seg_reduce(tt.aabb, o, d, cap, t_min=kw["t_min"], p=p, groups=p // group_rays,
                       only_tid=only_tid, exclude_tid=exclude_tid)
    seg_list, seg_entry, seg_gmask = segment_metadata(*meta, n_words, e_cap=e_cap)
    return SegmentLaunch(
        seg_list, seg_entry, seg_gmask, o.contiguous(), d.contiguous(), cap.contiguous(),
        None if ah is None else ah.contiguous(), order, n, kw,
    )


def _launch_for_kernels(lib, tt, o, d, cap, ah, order, n, p, group_rays, n_words, e_cap, kw,
                        only_tid=None, exclude_tid=None) -> SegmentLaunch:
    """``_launch_for`` through the metadata pass of ``lib``, which also pads
    the rays and any-hit mask."""
    o_s, d_s, cap_s, ah_s, seg_list, seg_entry, seg_gmask = tdk.meta_pass(
        lib, tt.aabb, o, d, cap, ah, order, p=p, group_rays=group_rays, n_words=n_words,
        t_min=kw["t_min"], only_tid=only_tid, exclude_tid=exclude_tid, e_cap=e_cap)
    return SegmentLaunch(seg_list, seg_entry, seg_gmask, o_s, d_s, cap_s, ah_s, order, n, kw)


def segment_rows(counts: torch.Tensor, p: int) -> torch.Tensor:
    """K5's per-ray counts [S·p, 5] → the reference's per-segment row shape
    [S, 8] int32: column sums over each segment's rays, in launch order
    (node pops, leaf pops, slab tests, Möller–Trumbore tests, steps
    traversed; 5-7 zero). The reference counts one shared packet per
    segment, so its columns 0, 1 and 4 are the pops and live steps of the
    packet, and its columns 2-3 are group activations (node and leaf pops
    times the 8-row ray groups active in them); here each ray walks alone,
    so the columns are sums over the segment's rays, and 2-3 count the
    tests done."""
    sums = counts.reshape(-1, p, 5).to(torch.int64).sum(dim=1)
    rows = torch.zeros((sums.shape[0], 8), dtype=torch.int32, device=counts.device)
    rows[:, :5] = sums.to(torch.int32)
    return rows


def finish(sl: SegmentLaunch, out: torch.Tensor, hit_only: bool = False) -> Hit:
    """K3's [4, S·p] rows → ``Hit`` in the caller's ray order; misses read
    as background. ``hit_only`` un-sorts just the prim row (``Hit.t`` is
    then 0 or background, ``uv`` zero)."""
    n, order, dev = sl.n, sl.order, out.device
    if hit_only and order is not None:
        prim = torch.empty_like(out[3])
        prim[order] = out[3]
        prim_id = prim[:n].to(torch.int32)
        found = prim_id >= 0
        return Hit(
            t=torch.where(found, 0.0, _BG),
            uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
            prim_id=prim_id, hit=found,
        )
    if order is not None:
        restored = torch.empty_like(out)
        restored[:, order] = out
        out = restored
    out = out[:, :n]
    prim_id = out[3].to(torch.int32)
    found = prim_id >= 0
    return Hit(
        t=torch.where(found, out[0], _BG),
        uv=torch.stack([out[1], out[2]], dim=-1),
        prim_id=prim_id, hit=found,
    )


def treelet_intersect(
    tt: TreeletTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 512, presorted: bool = False,
    anyhit_mask=None, step_cull: bool = False, max_groups: int = 32,
    hit_only: bool = False, sort_chunk: int = 1, e_cap=None, stats: bool = False,
    nearest_first: bool = False,
):
    """Trace rays [N, 3] through the treelet segment grid (module docstring).

    t_max: scalar or per-ray [N] (0 parks a lane). anyhit_mask ([N] bool):
    flagged lanes retire on their first accepted hit (``Hit.hit`` is their
    occlusion bit), unflagged lanes stay exact closest hits. presorted skips
    the coherence sort. step_cull clamps every cap to the ray's exit from
    the scene box (misses read as background all the same) and lets a ray
    skip a step once its best t is at or below the step's entry distance.
    hit_only (any-hit callers that read only ``Hit.hit``) un-sorts just the
    prim row; ``Hit.t`` is then 0 or background.

    Diagnostics of the reference, with its results: ``sort_chunk`` g > 1
    sorts g-ray chunks by their smallest key (the reference measured it
    slower everywhere); ``e_cap`` gives steps at or beyond it mask 0 (drops
    hits); ``nearest_first`` traces each ray through its nearest candidate
    treelet first, then the other candidates with its cap tightened to
    ``t·(1 + 1e-4) + 1e-5`` of that hit (sorted path only, sort_chunk 1,
    more than one treelet). ``stats=True`` returns ``(Hit, rows)``: int32
    [S, 8] per segment in launch order (``segment_rows``; the two phases of
    nearest_first summed).

    K3's inputs come from the key and metadata passes of
    ``csrc/treelet_driver.cu`` (``treelet_driver_kernel``) on CUDA tensors,
    which take every option here (a shape their kernels do not take
    raises), and from the plain PyTorch passes on CPU tensors, to the same
    bits."""
    n = origins.shape[0]
    k = tt.num_treelets
    p, group_rays, n_words = tk._segment_groups(sublanes, max_groups)
    prepare, launch_for = _passes(origins)
    o, d, cap, ah, order, tid = prepare(tt, origins, directions, t_min, t_max, p, presorted,
                                        anyhit_mask, step_cull, sort_chunk, nearest_first)
    kw = dict(t_min=t_min, any_hit=any_hit, step_cull=step_cull, sublanes=sublanes, max_groups=max_groups)
    geo = (n, p, group_rays, n_words, e_cap, kw)

    def run(sl):
        r = sl.launch(tt, stats=stats)
        return r if stats else (r, None)

    if nearest_first and order is not None and sort_chunk == 1 and k > 1:
        # Phase 1: the nearest candidate only (tid-sorted: near-pure unions).
        sl = launch_for(tt, o, d, cap, ah, order, *geo, only_tid=tid)
        out1, st1 = run(sl)
        # Phase 2: the other candidates, caps tightened to the phase-1 hit
        # (inflated so slab/Möller rounding keeps a boundary hit); misses
        # keep their exact cap, so a shadow ray admits nothing beyond it.
        # Its rays are phase 1's as they stand, sorted: no order to take
        # them in, and phase 1's maps them back.
        hit1 = out1[3] >= 0.0
        cap2 = torch.where(hit1, out1[0] * (1.0 + 1e-4) + 1e-5, sl.t_cap)
        sl = launch_for(tt, sl.origins, sl.directions, cap2, sl.anyhit_row, None, *geo,
                        exclude_tid=tid)._replace(order=order)
        out2, st2 = run(sl)
        better2 = (out2[3] >= 0.0) & (~hit1 | (out2[0] < out1[0]))
        out = torch.where(better2[None, :], out2, out1)
        rows = segment_rows(st1, p) + segment_rows(st2, p) if stats else None
    else:
        sl = launch_for(tt, o, d, cap, ah, order, *geo)
        out, st = run(sl)
        rows = segment_rows(st, p) if stats else None
    hit = finish(sl, out, hit_only and sort_chunk == 1 and not nearest_first and not stats)
    return (hit, rows) if stats else hit


def _bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """[N, W·32] bool → [N, W] int32 words (bit 31 is the sign bit)."""
    n, kw = bits.shape
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(n, kw // 32, 32).to(torch.int64) << shifts).sum(dim=-1)
    return _to_int32_bits(words)


def _words_to_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    n, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * 32)[:, :k].to(torch.bool)


class _RoundsSetup(NamedTuple):
    """What both rounds drivers compute before their first round: padded
    rays, the first caps and wanted treelets, and the segment layout."""

    n: int
    k: int
    o: torch.Tensor  # [N_pad, 3]
    d: torch.Tensor
    inv_d: torch.Tensor
    cap0: torch.Tensor  # [N_pad]
    want0: torch.Tensor  # [N_pad, K] bool
    pad_cols: torch.Tensor  # [N_pad, 32·⌈K/32⌉ - K] bool
    lo: torch.Tensor  # [3] the scene box
    hi: torch.Tensor
    kcols: torch.Tensor  # [K] int32
    # A round's launch pass arguments after its rays, caps, any-hit row and
    # order: (N_pad, p, group_rays, n_words, e_cap None, K3's keywords).
    geo: tuple


def _rounds_setup(tt: TreeletTables, origins, directions, t_min, t_max, any_hit, sublanes) -> _RoundsSetup:
    n = origins.shape[0]
    k = tt.num_treelets
    p, group_rays, n_words = tk._segment_groups(sublanes, 32)
    n_pad = -(-n // p) * p
    kw_bits = -(-k // 32) * 32
    dev = origins.device
    o, d, cap0 = _pad_rays(origins, directions, t_max, n_pad)
    return _RoundsSetup(
        n=n, k=k, o=o, d=d, inv_d=_inv_dir(d), cap0=cap0, want0=_slab_hits(tt.aabb, o, d, cap0, t_min),
        pad_cols=torch.zeros((n_pad, kw_bits - k), dtype=torch.bool, device=dev),
        lo=tt.aabb[:, 0:3].amin(dim=0), hi=tt.aabb[:, 3:6].amax(dim=0),
        kcols=torch.arange(k, dtype=torch.int32, device=dev),
        geo=(n_pad, p, group_rays, n_words, None,
             dict(t_min=t_min, any_hit=any_hit, step_cull=False, sublanes=sublanes, max_groups=32)))


def _first_state(rs: _RoundsSetup, stats: bool):
    """(pending words, best t, u, v, id, counts or None) before round 1."""
    n_pad, dev = rs.o.shape[0], rs.o.device
    zeros = [torch.zeros((n_pad,), dtype=torch.float32, device=dev) for _ in range(2)]
    return (_bits_to_words(torch.cat([rs.want0, rs.pad_cols], dim=1)), rs.cap0.clone(), *zeros,
            torch.full((n_pad,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n_pad, 5), dtype=torch.int32, device=dev) if stats else None)


def _rounds_result(rs: _RoundsSetup, best_t, best_u, best_v, best_id, counts, rounds, stats, return_rounds):
    n = rs.n
    found = best_id[:n] >= 0
    hit = Hit(
        t=torch.where(found, best_t[:n], _BG),
        uv=torch.stack([best_u[:n], best_v[:n]], dim=-1),
        prim_id=best_id[:n], hit=found,
    )
    extra = ((counts[:n],) if stats else ()) + ((rounds,) if return_rounds else ())
    return (hit, *extra) if extra else hit


def treelet_intersect_rounds(
    tt: TreeletTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 64, max_rounds: Optional[int] = None,
    return_rounds: bool = False, stats: bool = False, segment_fn=None,
):
    """Per-ray nearest-first rounds, K3's second driver: each round every
    live ray takes its nearest untried candidate treelet that still beats
    its best hit (a candidate the shrinking cap prunes stays pruned), rays
    re-sort by (chosen treelet, entry Morton code) into treelet-pure
    segments, and one K3 launch traces them. Runs until no ray has a
    candidate, or ``max_rounds`` (default K) rounds.

    ``segment_fn`` is the K3 entry each round calls
    (``packet_intersect_segments``, or its plain version). ``stats=True``
    launches K5 each round and adds ``counts``, int32 [N, 5] per ray
    summed over the rounds; ``return_rounds`` adds the number of rounds.
    Returns ``Hit``, or the tuple ``(Hit, [counts], [rounds])``.

    CUDA tensors run ``rounds_on_device`` over kernels F1 and F2 of
    ``csrc/oracle_bvh.cu`` (counted in ``traverse_kernel.LAUNCHES`` as
    ``rounds_pick``/``rounds_merge``) and each round's metadata pass
    (``treelet_meta``), or raise: nothing is read back, every one of the
    ``max_rounds or K`` rounds is launched, and the round count is a 0-d
    int64 tensor on the device. The metadata pass holds at most
    ``treelet_driver_kernel.MAX_TREELETS`` (256) treelets, as on
    ``treelet_intersect``'s CUDA path. CPU tensors run the plain version,
    ``treelet_intersect_rounds_plain`` (the count a Python int)."""
    dev = origins.device
    kw = dict(t_min=t_min, t_max=t_max, any_hit=any_hit, sublanes=sublanes, max_rounds=max_rounds,
              return_rounds=return_rounds, stats=stats, segment_fn=segment_fn)
    if dev.type == "cpu":
        return treelet_intersect_rounds_plain(tt, origins, directions, **kw)
    if dev.type != "cuda":
        raise ValueError(f"treelet_intersect_rounds runs on cpu or cuda tensors, not {dev}")
    lib = ok.load_kernels()

    def pick(*args):
        with torch.cuda.device(dev):
            out = ok.rounds_pick(lib, *args, torch.cuda.current_stream(dev).cuda_stream)
        tk.LAUNCHES["rounds_pick"] += 1
        return out

    def merge(*args):
        with torch.cuda.device(dev):
            ok.rounds_merge(lib, *args, torch.cuda.current_stream(dev).cuda_stream)
        tk.LAUNCHES["rounds_merge"] += 1

    return rounds_on_device(tt, origins, directions, pick, merge, **kw)


def rounds_on_device(
    tt: TreeletTables, origins, directions, pick, merge, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 64, max_rounds: Optional[int] = None,
    return_rounds: bool = False, stats: bool = False, segment_fn=None,
):
    """``treelet_intersect_rounds`` with nothing read back: exactly
    ``max_rounds or K`` rounds (the reference's bound), the round count and
    the go flag kept as 0-d tensors (``go`` starts as any ray wanting a
    treelet, ``rounds += go`` and ``go &= any(has)`` each round, so the
    count is the host loop's). A round after one in which no ray had a
    candidate changes nothing: F1 finds none again, K3 gets only steps
    whose group mask is 0, and F2 takes nothing and adds zero counts.

    ``pick`` is F1 (``oracle_kernels.rounds_pick`` without its library and
    stream: (pending, o, d, inv_d, best_t, best_id, any_hit, aabb, lo, hi,
    t_min) → (has, tid, key, cap, the next pending words)) and
    ``merge`` F2 (``oracle_kernels.rounds_merge`` likewise: it updates
    the bests and counts in place). Between them PyTorch's stable argsort
    sorts the round's keys, and the single pass's launch pass (``_passes``)
    builds the round's K3 inputs with each ray keeping only its chosen
    treelet (``only_tid``): F1 chose it among the boxes the ray enters
    within the round's cap, so that is the round's treelet-pure want. The
    card passes its kernels' wrappers; the CPU tests pass the host-shim
    build's. Returns as ``treelet_intersect_rounds``."""
    rs = _rounds_setup(tt, origins, directions, t_min, t_max, any_hit, sublanes)
    pending, best_t, best_u, best_v, best_id, counts = _first_state(rs, stats)
    _, launch_for = _passes(origins)
    go = rs.want0.any()
    rounds = torch.zeros((), dtype=torch.int64, device=origins.device)
    for _ in range(max_rounds or rs.k):
        has, tid, key, capr, pending = pick(pending, rs.o, rs.d, rs.inv_d, best_t, best_id, any_hit, tt.aabb, rs.lo,
                                            rs.hi, t_min)
        rounds += go.to(torch.int64)
        order = torch.argsort(key, stable=True)
        sl = launch_for(tt, rs.o, rs.d, capr, None, order, *rs.geo, only_tid=tid[order])
        out_s = sl.launch(tt, fn=segment_fn, stats=stats)
        out_s, c_s = out_s if stats else (out_s, None)
        merge(order, has, out_s, c_s, best_t, best_u, best_v, best_id, counts)
        go = go & has.any()
    return _rounds_result(rs, best_t, best_u, best_v, best_id, counts, rounds, stats, return_rounds)


def round_pick_plain(tt: TreeletTables, rs: _RoundsSetup, pending, best_t, best_id, any_hit: bool, t_min: float):
    """F1's plain version, a round's work before its sort: (has, tid, key,
    the round's cap, the next pending words), as ``rounds_pick`` gives
    them."""
    capr = torch.where(best_id >= 0, 0.0, best_t) if any_hit else best_t  # blocked: done
    near, tid, cand = _near_tid(tt.aabb, rs.o, rs.d, capr, t_min=t_min, mask=_words_to_bits(pending, rs.k))
    pending = _bits_to_words(torch.cat([cand & (rs.kcols[None, :] != tid[:, None]), rs.pad_cols], dim=1))
    del cand
    return torch.isfinite(near), tid, (tid << 18) | _entry_morton(rs.o, rs.d, near, rs.lo, rs.hi), capr, pending


def round_merge_plain(order, has, out_s, counts_s, best_t, best_u, best_v, best_id, counts):
    """F2's plain version, a round's work after K3: K3's rows [4, N] and
    counts [N, 5] (or None) in sorted order back to the rays, the bests
    taken where the ray had a candidate and K3 found a hit (``counts`` is
    added to in place). Returns the new (best_t, best_u, best_v, best_id,
    counts)."""
    if counts is not None:
        counts[order] += counts_s
    out = torch.empty_like(out_s)
    out[:, order] = out_s
    new_id = out[3].to(torch.int32)
    improved = has & (new_id >= 0)
    return (torch.where(improved, out[0], best_t), torch.where(improved, out[1], best_u),
            torch.where(improved, out[2], best_v), torch.where(improved, new_id, best_id), counts)


def treelet_intersect_rounds_plain(
    tt: TreeletTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 64, max_rounds: Optional[int] = None,
    return_rounds: bool = False, stats: bool = False, segment_fn=None,
):
    """The plain version of ``treelet_intersect_rounds`` on any device: the
    rounds looped on the host, which reads whether any ray has a candidate
    after each round and stops there (one read a round, so no CUDA graph
    holds it); F1's and F2's work in PyTorch, each round's launch pass as
    in ``rounds_on_device``. Returns as ``treelet_intersect_rounds``, the
    round count a Python int."""
    rs = _rounds_setup(tt, origins, directions, t_min, t_max, any_hit, sublanes)
    pending, best_t, best_u, best_v, best_id, counts = _first_state(rs, stats)
    _, launch_for = _passes(origins)
    rounds = 0
    go = bool(rs.want0.any())
    while go and rounds < (max_rounds or rs.k):
        has, tid, key, capr, pending = round_pick_plain(tt, rs, pending, best_t, best_id, any_hit, t_min)
        order = torch.argsort(key, stable=True)
        sl = launch_for(tt, rs.o, rs.d, capr, None, order, *rs.geo, only_tid=tid[order])
        out_s = sl.launch(tt, fn=segment_fn, stats=stats)
        out_s, c_s = out_s if stats else (out_s, None)
        best_t, best_u, best_v, best_id, counts = round_merge_plain(order, has, out_s, c_s, best_t, best_u, best_v,
                                                                    best_id, counts)
        rounds += 1
        go = bool(has.any())
    return _rounds_result(rs, best_t, best_u, best_v, best_id, counts, rounds, stats, return_rounds)


def treelet_layout_stats(tt: TreeletTables, origins, directions, t_cap, sublanes: int = 64) -> dict:
    """Driver-side diagnostics (no kernel): per-ray candidate counts and
    per-segment candidate-union sizes of a ray population after the
    coherence sort, the quantities that set the segment grid's step count.
    Host numbers."""
    n = origins.shape[0]
    k = tt.num_treelets
    p = sublanes * 128
    n_pad = -(-n // p) * p
    s_count = n_pad // p
    o, d, cap = _pad_rays(origins, directions, t_cap, n_pad)
    _, key, _ = key_pass_plain(tt.aabb, o, d, cap, t_min=1e-4, step_cull=False, sort=True)
    want = _slab_hits(tt.aabb, o, d, cap, 1e-4)
    union = torch.any(want[_sort_order(key, 1)].reshape(s_count, p, k), dim=1).sum(dim=1)
    cand = want.sum(dim=1)[:n]
    return {
        "rays": n,
        "segments": s_count,
        "cand_mean": float(cand.to(torch.float32).mean()),
        "cand_max": int(cand.max()),
        "union_mean": float(union.to(torch.float32).mean()),
        "union_max": int(union.max()),
        "steps": int(union.sum()),
    }


def treelet_backend(
    scene=None, leaf_size: int = 24, width: int = 16, max_tris: int = 98304,
    sublanes: int = 512, host_tris=None, *, device,
) -> TraceBackend:
    """TraceBackend over the treelet segment grid, with the reference's
    production settings: treelets of ≤ 98,304 triangles in leaf-24 clusters
    under width-16 nodes (SAH cut, SAH clusters), per-step culling, and
    tile-ordered primaries traced presorted in 512-sublane segments (65,536
    rays, ≤ 32 groups of 2,048) while the sorted bounce, occlusion and
    capped launches use 1,024-sublane segments (131,072 rays, 128 groups of
    1,024). Smaller ``sublanes`` (tests) serve both."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("treelet_backend: a CUDA device was asked for but none is available")
        tk.load_kernels()
    if host_tris is None:
        host_tris = tuple(t.detach().cpu().numpy() for t in scene.tri_vertices())
    v0, v1, v2 = host_tris
    tt = tables_to_device(
        build_treelets_host(
            v0, v1, v2, leaf_size, width=width, max_tris=max_tris, partition="sah",
            cluster_mode="sah",
        ),
        device,
    )
    sl_sorted = max(1024, sublanes) if sublanes >= 512 else sublanes
    meta = tt._replace(node_tables=None, cluster_tables=None, aabb=None)
    arrays = {"nodes": tt.node_tables, "clusters": tt.cluster_tables, "aabb": tt.aabb}

    def _tables(arrays) -> TreeletTables:
        return meta._replace(
            node_tables=arrays["nodes"], cluster_tables=arrays["clusters"], aabb=arrays["aabb"]
        )

    sorted_kw = dict(sublanes=sl_sorted, step_cull=True, max_groups=MAX_GROUPS_SORTED)

    def isect_fn(arrays, o, d):
        return treelet_intersect(_tables(arrays), o, d, **sorted_kw)

    def occl_fn(arrays, o, d, tmax):
        return treelet_intersect(
            _tables(arrays), o, d, t_max=tmax, any_hit=True, hit_only=True, **sorted_kw
        ).hit

    def capped_fn(arrays, o, d, tmax, anyhit=None):
        return treelet_intersect(_tables(arrays), o, d, t_max=tmax, anyhit_mask=anyhit, **sorted_kw)

    def primary_fn(arrays, o, d):
        return treelet_intersect(
            _tables(arrays), o, d, sublanes=sublanes, presorted=True, step_cull=True,
            max_groups=MAX_GROUPS_PRIMARY,
        )

    return TraceBackend(
        arrays, isect_fn, occl_fn, meta=tt, self_sorting=True, primary_fn=primary_fn,
        capped_fn=capped_fn,
    )
