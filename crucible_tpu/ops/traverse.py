"""Stackless lockstep BVH traversal for a wavefront of rays.

The reference traverses a pointer tree recursively, mutating shared AABBs
per ray (src/objects/bvhwrapper.rs:97-127) — per-ray mutation is the reason
every render thread clones the whole world there (SURVEY.md §2.7). Here
traversal is a single ``lax.while_loop`` over the whole ray batch: every ray
carries a DFS cursor into the flat skip-link BVH (ops/bvh.py); on bbox hit
at an inner node the cursor advances to the left child (``i+1``), otherwise
it follows the ``miss`` link. Closest-hit distance doubles as the shrinking
t_max, like the reference capping the right-child interval at the left hit
(bvhwrapper.rs:108-119).

All rays run in lockstep; the loop ends when every cursor has walked off the
end. The cursor is strictly increasing, so the step count is bounded by the
node count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from crucible_tpu.ops.intersect import BIG, MT_EPS


def _mt_single(o, d, a, b, c, t_min, t_max):
    """Möller–Trumbore for one (per-ray) triangle: all args (R, 3) except
    the scalar/broadcast t bounds. Returns (t, valid)."""
    return _mt_components(
        (o[:, 0], o[:, 1], o[:, 2]),
        (d[:, 0], d[:, 1], d[:, 2]),
        (a[:, 0], a[:, 1], a[:, 2]),
        (b[:, 0], b[:, 1], b[:, 2]),
        (c[:, 0], c[:, 1], c[:, 2]),
        t_min,
        t_max,
    )


def _mt_components(o, d, a, b, c, t_min, t_max):
    """Möller–Trumbore on component tuples ((R,) x 3 each) — the layout-
    safe form: (R,) arrays tile cleanly while (R, 3) pads its minor dim to
    128 lanes (CLAUDE.md layout poison). Same math as _mt_single /
    ops/intersect.py, FMA order preserved."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az = a
    e1x, e1y, e1z = b[0] - ax, b[1] - ay, b[2] - az
    e2x, e2y, e2z = c[0] - ax, c[1] - ay, c[2] - az
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = jnp.abs(det) > MT_EPS
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvx, tvy, tvz = ox - ax, oy - ay, oz - az
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = (
        det_ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, valid


def bvh_hit_triangles(
    o,
    d,
    v0,
    v1,
    v2,
    node_min,
    node_max,
    node_first,
    node_count,
    node_miss,
    t_min,
    t_max,
    leaf_size: int,
    v0d=None,
    v1d=None,
    v2d=None,
    w=None,
    vertex_fn=None,
):
    """Closest triangle hit through the flat BVH.

    Args:
      o, d: (R, 3) rays.
      v0, v1, v2: (M, 3) triangle vertices in LEAF ORDER (pre-permuted).
      node_*: flat BVH arrays (K nodes). For moving meshes the node boxes
        must enclose the shutter-open AND shutter-close vertex positions
        (union refit, ops/bvh.py).
      t_min, t_max: scalar acceptance bounds.
      leaf_size: static max primitives per leaf (unrolled).
      v0d/v1d/v2d, w: optional linear shutter motion — vertex(w) =
        v + w * vd with per-ray w (see hit_spheres_moving).
      vertex_fn: optional ``pid (R,) -> (a, b, c)`` candidate-vertex
        evaluator overriding the v0/v1/v2 gathers — the exact per-ray-time
        hook (piecewise-linear timeline tracks evaluated at each ray's
        absolute time, mirroring the reference's per-ray ``update_bb`` +
        leaf-timeline evaluation, src/objects/bvhwrapper.rs:102-106).
        Node boxes must then enclose the FULL trajectory over the shutter
        window (models/scene.py unions bounds over keyframe breakpoints).

    Returns:
      t: (R,) distance (BIG where miss)
      idx: (R,) winning triangle index in leaf order
      hit: (R,) bool
    """
    num_nodes = node_min.shape[0]
    num_prims = v0.shape[0]
    r = o.shape[0]

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d >= 0, 1e-30, -1e-30), d)
    ovec = (o[:, 0], o[:, 1], o[:, 2])
    dvec = (d[:, 0], d[:, 1], d[:, 2])

    def cond(state):
        cursor, _, _ = state
        return jnp.any(cursor < num_nodes)

    def body(state):
        cursor, t_best, idx_best = state
        done = cursor >= num_nodes
        cur = jnp.minimum(cursor, num_nodes - 1)

        lo = jnp.take(node_min, cur, axis=0)  # (R, 3)
        hi = jnp.take(node_max, cur, axis=0)
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        enter = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
        exit_ = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), t_best)
        box_hit = (enter <= exit_) & ~done

        count = jnp.take(node_count, cur, axis=0)
        first = jnp.take(node_first, cur, axis=0)
        is_leaf = count > 0

        def leaf_tests(carry):
            t_b, i_b = carry
            for li in range(leaf_size):
                pid = jnp.minimum(first + li, num_prims - 1)
                test = box_hit & is_leaf & (li < count)
                if vertex_fn is not None:
                    a, b, c = vertex_fn(pid)
                    av = (a[:, 0], a[:, 1], a[:, 2])
                    bv = (b[:, 0], b[:, 1], b[:, 2])
                    cv = (c[:, 0], c[:, 1], c[:, 2])
                else:
                    # COMPONENT-WISE (R,) gathers, never (R, 3): the
                    # leaf_size-unrolled gathers keep every candidate's
                    # vertices live at once, and (R,) columns keep those
                    # buffers dense.
                    def g3(arr):
                        return (
                            jnp.take(arr[:, 0], pid),
                            jnp.take(arr[:, 1], pid),
                            jnp.take(arr[:, 2], pid),
                        )

                    av, bv, cv = g3(v0), g3(v1), g3(v2)
                    if v0d is not None:
                        av = tuple(x + w * y for x, y in zip(av, g3(v0d)))
                        bv = tuple(x + w * y for x, y in zip(bv, g3(v1d)))
                        cv = tuple(x + w * y for x, y in zip(cv, g3(v2d)))
                t_hit, valid = _mt_components(ovec, dvec, av, bv, cv, t_min, t_b)
                upd = test & valid
                t_b = jnp.where(upd, t_hit, t_b)
                i_b = jnp.where(upd, pid, i_b)
            return t_b, i_b

        t_best, idx_best = leaf_tests((t_best, idx_best))

        miss_link = jnp.take(node_miss, cur, axis=0)
        nxt = jnp.where(
            box_hit & ~is_leaf,
            cur + 1,
            jnp.where(done, num_nodes, miss_link),
        )
        return nxt, t_best, idx_best

    cursor0 = jnp.zeros((r,), jnp.int32)
    t_best0 = jnp.full((r,), jnp.asarray(t_max, jnp.float32))
    idx0 = jnp.zeros((r,), jnp.int32)
    _, t_best, idx_best = jax.lax.while_loop(cond, body, (cursor0, t_best0, idx0))

    hit = t_best < jnp.minimum(jnp.asarray(t_max, jnp.float32), BIG)
    t_out = jnp.where(hit, t_best, BIG)
    return t_out, idx_best, hit
