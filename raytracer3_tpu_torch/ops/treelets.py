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

The metadata is the reference's to the bit (tests/test_torch_treelets.py):
the ``(1 - 1e-4)``/``1e-5`` nudges round as float32 constants, sentinel slots
repeat the last real id with a zero group mask, and the stable sort keeps
the reference's tie order. TPU mechanics are not ported: the VMEM auto-fit,
``SEG_LAUNCH_CHUNK`` (one launch covers every segment here), and the
``half_leaf``/``bit_loop``/``rank_push``/``div_free``/``bw_leaf``/
``tables_hbm``/``vmem_limit`` flags. The slab reductions run densely over
ray chunks instead of the reference's ``lax.map`` (same results).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer3_tpu_torch.ops import cluster_bvh as cb_mod
from raytracer3_tpu_torch.ops import mathx
from raytracer3_tpu_torch.ops import traverse_kernel as tk
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
    depth: int  # max treelet depth (stack sizing)
    num_treelets: int
    max_nodes: int
    max_clusters: int
    leaf_aabb: bool = False  # cluster rows carry AABBs in lanes [10L, 10L+6)


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
    partition: str = "sah", cluster_mode: str = "median",
) -> TreeletTables:
    """Partition triangles into treelets and build each treelet's wide
    cluster BVH; numpy in, numpy tables out.

    partition: "sah" (overlap-minimizing cut) or "median"."""
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

    nodes, clusters, aabbs, depth = [], [], [], 1
    for idx in parts:
        cb = cb_mod.build_cluster_bvh_host(
            v0[idx], v1[idx], v2[idx], leaf_size, width=width, cluster_mode=cluster_mode,
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
        leaf_aabb=True,
    )


def tables_to_device(tt: TreeletTables, device) -> TreeletTables:
    """Upload the three tables of ``tt`` (numpy or tensors) to ``device``."""

    def up(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32).contiguous()
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return tt._replace(
        node_tables=up(tt.node_tables), cluster_tables=up(tt.cluster_tables), aabb=up(tt.aabb)
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


def _morton6(pos, lo, hi):
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


def _seg_reduce(aabb, o, d, cap, *, t_min, p, groups):
    """Per-segment slab reductions: (seg_tn [S, K] min entry t over the
    rays that want each treelet, seg_any [S, K], gact [S, G, K] which ray
    groups want it). Dense over chunks of whole segments."""
    k = aabb.shape[0]
    s_count = o.shape[0] // p
    step = max(1, _SLAB_CHUNK // p)
    seg_tn, seg_any, gact = [], [], []
    for s0 in range(0, s_count, step):
        cs = min(step, s_count - s0)
        r = slice(s0 * p, (s0 + cs) * p)
        tn, want = _treelet_slabs(aabb, o[r], _inv_dir(d[r]), t_min, cap[r])
        tn_m = torch.where(want, tn, torch.inf).reshape(cs, p, k)
        w = want.reshape(cs, p, k)
        seg_tn.append(torch.amin(tn_m, dim=1))
        seg_any.append(torch.any(w, dim=1))
        gact.append(torch.any(w.reshape(cs, groups, p // groups, k), dim=2))
    return torch.cat(seg_tn), torch.cat(seg_any), torch.cat(gact)


def _near_tid(aabb, o, d, cap, *, t_min):
    """Per-ray (nearest candidate entry t, its treelet id; K where none),
    the sort key's first field."""
    k = aabb.shape[0]
    near, tid = [], []
    for s0 in range(0, o.shape[0], _SLAB_CHUNK):
        r = slice(s0, s0 + _SLAB_CHUNK)
        tn, want = _treelet_slabs(aabb, o[r], _inv_dir(d[r]), t_min, cap[r])
        tn_m = torch.where(want, tn, torch.inf)
        nr = torch.amin(tn_m, dim=1)
        near.append(nr)
        tid.append(torch.where(torch.isfinite(nr), torch.argmin(tn_m, dim=1).to(torch.int32), k))
    return torch.cat(near), torch.cat(tid)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32-bit patterns → int32 (bit 31 wraps to the sign)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def segment_metadata(seg_tn, seg_any, gact, n_words: int):
    """(seg_list [S, E] i32, seg_entry [S, E] f32, seg_gmask [S, E, W] i32):
    near-first candidate lists whose sentinel slots repeat the last real id
    with a zero group mask, each step's min entry distance nudged down so fp
    jitter between the slab test and the Möller parameter cannot cull a
    boundary hit (1e30 on sentinels), and the group bitmask words."""
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

    def launch(self, tt: TreeletTables, fn=None) -> torch.Tensor:
        """Run K3 (``fn`` defaults to ``packet_intersect_segments``) →
        [4, S·p] rows in segment order."""
        fn = fn or tk.packet_intersect_segments
        return fn(tt, self.seg_list, self.seg_entry, self.seg_gmask, self.origins,
                  self.directions, self.t_cap, anyhit_row=self.anyhit_row, **self.kw)


def segment_launch(
    tt: TreeletTables, origins, directions, t_min: float = 1e-4, t_max=_BG,
    any_hit: bool = False, sublanes: int = 512, presorted: bool = False,
    anyhit_mask=None, step_cull: bool = False, max_groups: int = 32,
) -> SegmentLaunch:
    """The driver up to the kernel: pad, scene-exit caps (``step_cull``),
    coherence sort, slab reductions and segment metadata."""
    n = origins.shape[0]
    k = tt.num_treelets
    p, group_rays, n_words = tk._segment_groups(sublanes, max_groups)
    n_pad = -(-n // p) * p
    pad = n_pad - n
    dev = origins.device
    if isinstance(t_max, torch.Tensor) and t_max.ndim > 0:
        t_cap = t_max.to(torch.float32)
    else:
        t_cap = torch.full((n,), float(t_max), dtype=torch.float32, device=dev)
    o = torch.cat([origins, torch.full((pad, 3), 1e30, dtype=torch.float32, device=dev)])
    d = torch.cat([directions, torch.ones((pad, 3), dtype=torch.float32, device=dev)])
    cap = torch.cat([t_cap, torch.zeros((pad,), dtype=torch.float32, device=dev)])
    ah = None
    if anyhit_mask is not None:
        ah = torch.cat([anyhit_mask.to(torch.float32), torch.zeros((pad,), dtype=torch.float32, device=dev)])

    aabb = tt.aabb
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

    order = None
    if not presorted and k > 1:
        near, tid0 = _near_tid(aabb, o, d, cap, t_min=t_min)
        octant = (
            (d[:, 0] >= 0).to(torch.int32)
            + 2 * (d[:, 1] >= 0).to(torch.int32)
            + 4 * (d[:, 2] >= 0).to(torch.int32)
        )
        entry = torch.where(
            torch.isfinite(near)[:, None], o + torch.clamp_min(near, 0.0)[:, None] * d, 1e30
        )
        key = (tid0 << 21) | (octant << 18) | _morton6(entry, lo_s, hi_s)
        order = torch.argsort(key, stable=True)
        o, d, cap = o[order], d[order], cap[order]
        if ah is not None:
            ah = ah[order]

    seg_list, seg_entry, seg_gmask = segment_metadata(
        *_seg_reduce(aabb, o, d, cap, t_min=t_min, p=p, groups=p // group_rays), n_words
    )
    return SegmentLaunch(
        seg_list, seg_entry, seg_gmask, o.contiguous(), d.contiguous(), cap.contiguous(),
        None if ah is None else ah.contiguous(), order, n,
        dict(t_min=t_min, any_hit=any_hit, step_cull=step_cull, sublanes=sublanes, max_groups=max_groups),
    )


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
    hit_only: bool = False,
) -> Hit:
    """Trace rays [N, 3] through the treelet segment grid (module docstring).

    t_max: scalar or per-ray [N] (0 parks a lane). anyhit_mask ([N] bool):
    flagged lanes retire on their first accepted hit (``Hit.hit`` is their
    occlusion bit), unflagged lanes stay exact closest hits. presorted skips
    the coherence sort. step_cull clamps every cap to the ray's exit from
    the scene box (misses read as background all the same) and lets a ray
    skip a step once its best t is at or below the step's entry distance.
    hit_only (any-hit callers that read only ``Hit.hit``) un-sorts just the
    prim row; ``Hit.t`` is then 0 or background."""
    sl = segment_launch(
        tt, origins, directions, t_min=t_min, t_max=t_max, any_hit=any_hit, sublanes=sublanes,
        presorted=presorted, anyhit_mask=anyhit_mask, step_cull=step_cull, max_groups=max_groups,
    )
    return finish(sl, sl.launch(tt), hit_only)


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
