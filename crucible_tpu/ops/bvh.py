"""Host-side BVH construction into flat, stackless-traversal-ready arrays.

Topology follows the reference builder (src/objects/bvhwrapper.rs:46-80):
recursive top-down, sort the span by bbox-min along the longest axis of the
span's enclosing box, median split. Instead of a pointer tree traversed with
per-ray ``&mut self`` AABB mutation (src/objects/bvhwrapper.rs:97-127), we
emit nodes in DFS order with *skip links*:

  - on bbox hit at an inner node, advance to ``i + 1`` (its left child);
  - on miss (or after testing a leaf), jump to ``miss[i]``;
  - traversal ends when the cursor reaches ``num_nodes``.

This makes traversal a branch-free lockstep loop over a whole ray wavefront
(see ops/traverse.py) — the wavefront answer to divergent recursive descent.

Primitives are permuted into leaf order (``perm``) so leaves address
contiguous ranges; animated refit recomputes only the box arrays bottom-up,
fixing the reference's stale-inner-node problem (SURVEY.md §2.2) instead of
reproducing it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    """Flat DFS-ordered BVH. All arrays are NumPy; converted to jnp by the
    scene builder."""

    node_min: np.ndarray  # (K, 3) f32
    node_max: np.ndarray  # (K, 3) f32
    node_first: np.ndarray  # (K,) i32 — first primitive (leaf), else 0
    node_count: np.ndarray  # (K,) i32 — primitive count (0 for inner nodes)
    node_miss: np.ndarray  # (K,) i32 — skip link
    node_parent: np.ndarray  # (K,) i32 — parent index (-1 for root), for refit
    perm: np.ndarray  # (M,) i32 — primitive permutation into leaf order

    @property
    def num_nodes(self) -> int:
        return len(self.node_min)


_SAH_BINS = 16


def _sah_split(span, centers, bb_min, bb_max, leaf_size=0):
    """Binned SAH split of ``span``: pick the (axis, plane) minimizing
    N_L*Area_L + N_R*Area_R over 16 centroid bins per axis; returns
    (left, right) index arrays. Falls back to a longest-axis median when
    every candidate is degenerate (all centroids coincident).

    With ``leaf_size > 0`` the split COUNT is snapped to the nearest
    multiple of leaf_size (ordering by centroid along the SAH axis): the
    staged traversal's leaf test always costs ``leaf_size`` MT rows
    regardless of the leaf's fill, so partially-filled leaves burn rows for
    nothing — snapping makes every leaf full except one ragged tail per
    subtree."""
    c = centers[span]
    clo, chi = c.min(axis=0), c.max(axis=0)
    best = None  # (cost, axis, bin_id, bin_of)
    for axis in range(3):
        extent = chi[axis] - clo[axis]
        if extent <= 0:
            continue
        t = (c[:, axis] - clo[axis]) * (_SAH_BINS / extent)
        bin_of = np.minimum(t.astype(np.int64), _SAH_BINS - 1)
        counts = np.bincount(bin_of, minlength=_SAH_BINS)
        blo = np.full((_SAH_BINS, 3), np.inf)
        bhi = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(blo, bin_of, bb_min[span])
        np.maximum.at(bhi, bin_of, bb_max[span])
        # prefix (left-of-plane) and suffix (right-of-plane) sweeps
        l_lo = np.minimum.accumulate(blo, axis=0)
        l_hi = np.maximum.accumulate(bhi, axis=0)
        r_lo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        r_hi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        n_l = np.cumsum(counts)[:-1]
        n_r = len(span) - n_l

        def area(lo, hi):
            d = np.maximum(hi - lo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = n_l * area(l_lo, l_hi)[:-1] + n_r * area(r_lo, r_hi)[1:]
        cost = np.where((n_l == 0) | (n_r == 0), np.inf, cost)
        b = int(np.argmin(cost))
        if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
            best = (float(cost[b]), axis, b, bin_of)
    if best is None:
        axis = int(np.argmax(bb_max[span].max(0) - bb_min[span].min(0)))
        order = span[np.argsort(bb_min[span, axis], kind="stable")]
        k = len(order) // 2
        if leaf_size:
            k = _snap_count(k, len(order), leaf_size)
        return order[:k], order[k:]
    _, axis, b, bin_of = best
    if not leaf_size:
        mask = bin_of <= b
        return span[mask], span[~mask]
    order = span[np.argsort(c[:, axis], kind="stable")]
    k = _snap_count(int(np.count_nonzero(bin_of <= b)), len(order), leaf_size)
    return order[:k], order[k:]


def _snap_count(k, n, leaf_size):
    """Round split count k to the nearest multiple of leaf_size in (0, n)."""
    k = int(round(k / leaf_size)) * leaf_size
    return max(leaf_size, min(k, ((n - 1) // leaf_size) * leaf_size))


def build_bvh(
    bb_min: np.ndarray,
    bb_max: np.ndarray,
    leaf_size: int = 4,
    use_native: bool = True,
    method: str = "median",
    order_dir=None,
) -> FlatBVH:
    """Build a flat BVH over M primitive AABBs.

    Args:
      bb_min, bb_max: (M, 3) primitive bounds.
      leaf_size: max primitives per leaf (the reference recurses to single-
        primitive leaves, duplicating span==1 leaves into both children
        (bvhwrapper.rs:59-61); grouping a few prims per leaf is strictly
        better for vectorized leaf tests).
      use_native: try the C++ builder (crucible_tpu/native) first — same
        topology, much faster for large meshes; falls back silently.
      method: "median" reproduces the reference's sort + median-count split
        (bvhwrapper.rs:46-80); "sah" is a binned surface-area-heuristic
        split (16 centroid bins per axis). SAH produces spatially tighter,
        less-overlapping children, which matters doubly for lockstep
        traversal: the wavefront walks every node ANY of its rays hits, so
        child overlap multiplies union-leaf visits.
      order_dir: optional (3,) direction; children are emitted NEAR-FIRST
        along it (child-centroid projection). The skip-link DFS then visits
        leaves roughly front-to-back for rays along that direction (e.g.
        the camera view axis), tightening best-t earlier and culling later
        subtrees — a traversal-order heuristic the pointer-tree reference
        gets per-ray from its left-then-capped-right recursion
        (bvhwrapper.rs:108-119).
    """
    if use_native and method in ("median", "sah") and order_dir is None:
        from crucible_tpu import native

        out = native.build_bvh_native(bb_min, bb_max, leaf_size, method=method)
        if out is not None:
            return FlatBVH(**out)
    m = len(bb_min)
    assert m > 0, "empty BVH"
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    centers = 0.5 * (bb_min + bb_max)

    # Each entry: (prim_indices, left, right) built recursively; nodes listed
    # in DFS order so `left == index + 1` implicitly.
    node_min, node_max, node_first, node_count, node_parent = [], [], [], [], []
    perm: list[int] = []

    def emit(parent: int) -> int:
        idx = len(node_min)
        node_min.append(None)
        node_max.append(None)
        node_first.append(0)
        node_count.append(0)
        node_parent.append(parent)
        return idx

    # Explicit-stack pre-order build (like the C++ builders): Python
    # recursion on a skewed tree can blow the interpreter's C stack and
    # segfault well below any raised recursionlimit (ADVICE r3). Pushing
    # the right child first keeps DFS emission order (left == idx + 1).
    stack: list[tuple[np.ndarray, int]] = [(np.arange(m), -1)]
    while stack:
        span, parent = stack.pop()
        idx = emit(parent)
        lo = bb_min[span].min(axis=0)
        hi = bb_max[span].max(axis=0)
        node_min[idx] = lo
        node_max[idx] = hi
        if len(span) <= leaf_size:
            node_first[idx] = len(perm)
            node_count[idx] = len(span)
            perm.extend(span.tolist())
            continue
        if method == "sah":
            left, right = _sah_split(span, centers, bb_min, bb_max, leaf_size)
        else:
            axis = int(np.argmax(hi - lo))  # longest_axis (bvh.rs:82-94)
            order = span[np.argsort(bb_min[span, axis], kind="stable")]
            mid = len(order) // 2
            left, right = order[:mid], order[mid:]
        if order_dir is not None:
            dvec = np.asarray(order_dir, np.float64)
            if centers[left].mean(0) @ dvec > centers[right].mean(0) @ dvec:
                left, right = right, left
        stack.append((right, idx))
        stack.append((left, idx))

    k = len(node_min)
    parents = np.asarray(node_parent, np.int32)
    counts = np.asarray(node_count, np.int32)

    # Miss links: for the DFS layout, a node's miss target is the next node
    # that is not in its subtree. Compute via subtree extents: walk nodes in
    # reverse, tracking each node's subtree end.
    subtree_end = np.zeros(k, np.int32)  # exclusive end of each subtree
    # DFS property: a subtree occupies a contiguous index range. The end of
    # node i's range is the start of its next sibling (or parent's end).
    # Compute by propagating: leaves end at i+1; an inner node ends where its
    # right child ends (right child = last child emitted).
    children: list[list[int]] = [[] for _ in range(k)]
    for i in range(1, k):
        children[parents[i]].append(i)
    for i in range(k - 1, -1, -1):
        if counts[i] > 0:
            subtree_end[i] = i + 1
        else:
            subtree_end[i] = subtree_end[children[i][-1]]
    miss = subtree_end  # skip link == first node after the subtree

    return FlatBVH(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        node_first=np.asarray(node_first, np.int32),
        node_count=counts,
        node_miss=miss.astype(np.int32),
        node_parent=parents,
        perm=np.asarray(perm, np.int32),
    )


def reorder_front_to_back(b: FlatBVH, order_dir) -> FlatBVH:
    """Re-emit the flat BVH with children ordered NEAR-FIRST along
    ``order_dir`` (child box-center projection). The skip-link DFS then
    visits leaves roughly front-to-back for rays along that direction (the
    camera view axis), tightening best-t earlier and box-culling later
    subtrees — tools/walk_sim.py measures 13.2 -> 9.8 union-leaf visits
    per tile-bounce on the teapot. A post-pass, so it composes with the
    native C++ builders. The pointer-tree reference gets a per-ray version
    of this from its left-then-capped-right recursion
    (bvhwrapper.rs:108-119)."""
    d = np.asarray(order_dir, np.float64)
    k = b.num_nodes
    proj = (0.5 * (b.node_min + b.node_max) @ d).astype(np.float64)
    out_min, out_max, out_first, out_count, out_parent = [], [], [], [], []
    perm_runs = []
    perm_len = 0

    # Explicit-stack pre-order re-emission (a skewed SAH tree on a large
    # mesh can exceed the interpreter's C stack under recursion and
    # segfault — ADVICE r3; this runs on every triangle-mesh Scene.build).
    stack: list[tuple[int, int]] = [(0, -1)]
    while stack:
        i, parent = stack.pop()
        idx = len(out_min)
        out_min.append(b.node_min[i])
        out_max.append(b.node_max[i])
        out_parent.append(parent)
        c = int(b.node_count[i])
        if c > 0:
            out_first.append(perm_len)
            out_count.append(c)
            f = int(b.node_first[i])
            perm_runs.append(b.perm[f : f + c])
            perm_len += c
            continue
        out_first.append(0)
        out_count.append(0)
        left = i + 1
        right = int(b.node_miss[left])
        first, second = (
            (left, right) if proj[left] <= proj[right] else (right, left)
        )
        stack.append((second, idx))
        stack.append((first, idx))

    counts = np.asarray(out_count, np.int32)
    parents = np.asarray(out_parent, np.int32)
    children: list[list[int]] = [[] for _ in range(k)]
    for i in range(1, k):
        children[parents[i]].append(i)
    subtree_end = np.zeros(k, np.int32)
    for i in range(k - 1, -1, -1):
        subtree_end[i] = i + 1 if counts[i] > 0 else subtree_end[children[i][-1]]

    return FlatBVH(
        node_min=np.stack(out_min).astype(np.float32),
        node_max=np.stack(out_max).astype(np.float32),
        node_first=np.asarray(out_first, np.int32),
        node_count=counts,
        node_miss=subtree_end,
        node_parent=parents,
        perm=np.concatenate(perm_runs).astype(np.int32),
    )


def refit_bounds(bvh: FlatBVH, prim_min: np.ndarray, prim_max: np.ndarray):
    """Recompute node bounds bottom-up for moved primitives (same topology).

    ``prim_min``/``prim_max`` are in the ORIGINAL primitive order; ``perm``
    maps leaf slots to them. Returns (node_min, node_max) NumPy arrays.
    """
    k = bvh.num_nodes
    node_min = np.full((k, 3), np.inf, np.float32)
    node_max = np.full((k, 3), -np.inf, np.float32)
    for i in range(k - 1, -1, -1):
        c = bvh.node_count[i]
        if c > 0:
            prims = bvh.perm[bvh.node_first[i] : bvh.node_first[i] + c]
            node_min[i] = prim_min[prims].min(axis=0)
            node_max[i] = prim_max[prims].max(axis=0)
        p = bvh.node_parent[i]
        if p >= 0:
            node_min[p] = np.minimum(node_min[p], node_min[i])
            node_max[p] = np.maximum(node_max[p], node_max[i])
    return node_min, node_max
