"""Binary → wide BVH collapse, host-side numpy (port of the build half of
``raytracer3_tpu/ops/wide_bvh.py``: ``_binary_ranges`` and ``collapse``).
The output must equal the reference's exactly: the cluster-BVH tables built
from it are compared bit for bit."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

WIDTH = 8
_LEAF_COUNT_BITS = 4
_LEAF_COUNT_MAX = (1 << _LEAF_COUNT_BITS) - 1


class WideBVH(NamedTuple):
    child_min: np.ndarray  # [W, width, 3] f32 (+inf for empty slots)
    child_max: np.ndarray  # [W, width, 3] f32 (-inf for empty slots)
    # empty → -1; internal → wide node id (>= 0);
    # leaf → -(start << 4 | count) - 2  (count in [1, 15])
    child_code: np.ndarray  # [W, width] int32
    tri_order: np.ndarray  # [T] int32 leaf order of the primitives


def _binary_ranges(left: np.ndarray, right: np.ndarray, t: int):
    """Leaf-range [lo, hi] per binary internal node (iterative postorder)."""
    lo = np.full(t - 1, -1, np.int64)
    hi = np.full(t - 1, -1, np.int64)

    def leaf_range(c):
        if c >= t - 1:
            k = c - (t - 1)
            return k, k
        return None

    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        l, r = left[node], right[node]
        if processed:
            llo, lhi = (leaf_range(l) or (lo[l], hi[l]))
            rlo, rhi = (leaf_range(r) or (lo[r], hi[r]))
            lo[node] = min(llo, rlo)
            hi[node] = max(lhi, rhi)
        else:
            stack.append((node, True))
            for c in (l, r):
                if c < t - 1:
                    stack.append((int(c), False))
    return lo, hi


def collapse(bvh, leaf_size: int = 4, width: int = WIDTH) -> WideBVH:
    """Collapse a binary BVH (``node_min/max [2T-1,3]``, ``node_left/right
    [T-1]``, ``leaf_tri [T]``) into a ``width``-ary BVH."""
    if not 1 <= leaf_size <= _LEAF_COUNT_MAX:
        raise ValueError(f"leaf_size must be in [1, {_LEAF_COUNT_MAX}], got {leaf_size}")
    t = len(bvh.leaf_tri)
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    lo, hi = _binary_ranges(left, right, t)

    def subtree_size(b):
        if b >= t - 1:
            return 1
        return int(hi[b] - lo[b] + 1)

    def subtree_range(b):
        if b >= t - 1:
            k = b - (t - 1)
            return k, k
        return int(lo[b]), int(hi[b])

    wide_children: list = [None]  # per wide node: list of binary ids
    # Build wide nodes breadth-first; each entry is a binary node id to expand.
    pending = [0]
    wide_of_binary = {0: 0}
    while pending:
        b = pending.pop(0)
        w = wide_of_binary[b]
        # Gather up to `width` slots by splitting the largest internal child.
        slots = [left[b], right[b]] if b < t - 1 else [b]
        while len(slots) < width:
            best = -1
            best_sz = 0
            for si, sb in enumerate(slots):
                if sb < t - 1:
                    sz = subtree_size(sb)
                    if sz > leaf_size and sz > best_sz:
                        best, best_sz = si, sz
            if best < 0:
                break
            sb = slots.pop(best)
            slots.extend([left[sb], right[sb]])
        wide_children[w] = list(slots)
        # Children that stay internal become new wide nodes.
        for sb in slots:
            sb = int(sb)
            if sb < t - 1 and subtree_size(sb) > leaf_size:
                if sb not in wide_of_binary:
                    wide_of_binary[sb] = len(wide_children)
                    wide_children.append(None)
                    pending.append(sb)

    wn = len(wide_children)
    child_min = np.full((wn, width, 3), np.inf, np.float32)
    child_max = np.full((wn, width, 3), -np.inf, np.float32)
    child_code = np.full((wn, width), -1, np.int32)

    for b, w in wide_of_binary.items():
        for si, sb in enumerate(wide_children[w]):
            sb = int(sb)
            if sb >= t - 1:  # single-primitive binary leaf
                start = sb - (t - 1)
                code = -((start << _LEAF_COUNT_BITS) | 1) - 2
            elif subtree_size(sb) <= leaf_size:  # multi-primitive leaf range
                start, end = subtree_range(sb)
                code = -((start << _LEAF_COUNT_BITS) | (end - start + 1)) - 2
            else:  # internal
                code = wide_of_binary[sb]
            child_min[w, si] = nmin[sb]
            child_max[w, si] = nmax[sb]
            child_code[w, si] = code

    return WideBVH(
        child_min=child_min,
        child_max=child_max,
        child_code=child_code,
        tri_order=np.asarray(bvh.leaf_tri).astype(np.int32),
    )
