"""Batched closest-hit primitive intersection.

Sphere math follows the reference quadratic (src/objects/sphere.rs:61-105):
``oc = c - o``, ``h = d.oc``, ``c = |oc|^2 - r^2``, roots
``(h -/+ sqrt(h^2 - a c)) / a`` with the near root preferred, accepted iff
strictly inside (t_min, t_max) (Interval::surrounds, src/utils.rs:656-659),
evaluated in the equivalent geometric form of :func:`_roots`.

For R rays x N spheres every (ray, sphere) pair forms its own ``oc`` from
broadcast f32 subtractions and multiply-adds, and the winner's distance and
index come from ONE variadic min-reduction (:func:`min_with_index`).
Everything from the broadcasts to the reduction is elementwise-into-reduce,
so XLA emits a single row-reduction fusion and no (R, N) array reaches
device memory. Forming ``oc`` per pair avoids the cancellation that the
expanded ``|c|^2 - 2 o.c + |o|^2 - r^2`` suffers for rays leaving a
surface. Matrix units do not apply: K=3 is tiny, and bf16
products corrupt the quadratic (7.6% wrong hit decisions measured against
f32).

Triangle math is batched Möller–Trumbore (src/objects/triangle.rs:84-140)
with the same epsilon (1e-8) for parallel rays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Plain NumPy so importing never initializes a JAX backend.
BIG = np.float32(3.0e38)  # sentinel "no hit" distance (finite to keep grads clean)
MT_EPS = 1e-8


def min_with_index(t_all):
    """(min over the last axis, index of the FIRST minimum) in one variadic
    reduction — ``argmin`` semantics, without re-reading ``t_all`` for the
    winner's value."""
    idx = jax.lax.broadcasted_iota(jnp.int32, t_all.shape, t_all.ndim - 1)

    def lexmin(a, b):
        (ta, ia), (tb, ib) = a, b
        take_b = (tb < ta) | ((tb == ta) & (ib < ia))
        return jnp.where(take_b, tb, ta), jnp.where(take_b, ib, ia)

    return jax.lax.reduce(
        (t_all, idx),
        (jnp.array(np.inf, t_all.dtype), jnp.int32(0)),
        lexmin,
        (t_all.ndim - 1,),
    )


def hit_spheres(o, d, centers, radii, active, t_min, t_max):
    """Closest sphere hit per ray — differentiable with an O(R) backward.

    Forward is :func:`_hit_spheres_impl`; the custom VJP differentiates the
    hit distance as an IMPLICIT function of the winning sphere's quadratic
    f(t) = |o + t d - c|^2 - r^2 = 0, so the backward pass touches only the
    R winners (dt/dtheta = -(df/dtheta)/(df/dt)) instead of rematerializing
    the (R, N) candidate matrix — mathematically identical to autodiff
    through the root formula (argmin winners are detached either way), and
    the enabler for large fwd+bwd ray batches.

    Args:
      o, d: ray origins/directions, (R, 3). d need not be normalized
        (the reference never normalizes primary directions).
      centers: (N, 3) static scene, or (R, N, 3) when per-ray times animate
        the scene (motion blur — reference evaluates the timeline per ray,
        src/objects/sphere.rs:67-69).
      radii: (N,) or (R, N).
      active: (N,) or (R, N) bool — False for hidden/padding spheres
        (reference ``hide`` flag, src/objects/sphere.rs:62-64).
      t_min, t_max: scalar acceptance interval (exclusive, "surrounds").

    Returns:
      t: (R,) hit distance (BIG where no hit)
      idx: (R,) int32 index of the winning sphere (0 where no hit)
      hit: (R,) bool
    """
    return _closest_hit(
        o, d, centers, radii,
        jnp.asarray(active).astype(jnp.float32),
        jnp.asarray(t_min, jnp.float32),
        jnp.asarray(t_max, jnp.float32),
    )


@jax.custom_vjp
def _closest_hit(o, d, centers, radii, active_f, t_min, t_max):
    return _hit_spheres_impl(o, d, centers, radii, active_f > 0.0, t_min, t_max)


def _closest_hit_fwd(o, d, centers, radii, active_f, t_min, t_max):
    out = _hit_spheres_impl(o, d, centers, radii, active_f > 0.0, t_min, t_max)
    t, idx, hit = out
    return out, (o, d, centers, radii, active_f, t, idx, hit)


def _closest_hit_bwd(res, cts):
    o, d, centers, radii, active_f, t, idx, hit = res
    t_bar = cts[0]  # cotangents of idx/hit are symbolic zeros
    if centers.ndim == 2:
        c_w = jnp.take(centers, idx, axis=0)  # (R, 3)
        r_w = jnp.take(radii, idx, axis=0)
    else:
        c_w = jnp.take_along_axis(centers, idx[:, None, None], axis=1)[:, 0]
        r_w = jnp.take_along_axis(radii, idx[:, None], axis=1)[:, 0]
    # Miss lanes carry t = BIG; 3e38 * |d| overflows to inf and 0 * inf
    # would NaN the masked-out products below — mask t first.
    t_safe = jnp.where(hit, t, 1.0)
    nvec = o + t_safe[:, None] * d - c_w  # hit point minus center
    den = jnp.sum(d * nvec, axis=-1)  # = (df/dt)/2 at the root
    # Guard tangent hits (den ~ 0, where the true derivative diverges).
    safe_den = jnp.where(jnp.abs(den) > 1e-12, den, 1.0)
    g = jnp.where(hit & (jnp.abs(den) > 1e-12), t_bar / safe_den, 0.0)
    go = -g[:, None] * nvec  # dt/do = -nvec/den
    gd = -(g * t_safe)[:, None] * nvec  # dt/dd = -t*nvec/den
    gc_rows = jnp.where(hit[:, None], g[:, None] * nvec, 0.0)  # dt/dc = +nvec/den
    gr_rows = jnp.where(hit, g * r_w, 0.0)  # dt/dr = r/den
    if centers.ndim == 2:
        gc = jnp.zeros_like(centers).at[idx].add(gc_rows)
        gr = jnp.zeros_like(radii).at[idx].add(gr_rows)
    else:
        r_ar = jnp.arange(idx.shape[0])
        gc = jnp.zeros_like(centers).at[r_ar, idx].add(gc_rows)
        gr = jnp.zeros_like(radii).at[r_ar, idx].add(gr_rows)
    zero = jnp.zeros((), jnp.float32)
    return go, gd, gc, gr, jnp.zeros_like(active_f), zero, zero


_closest_hit.defvjp(_closest_hit_fwd, _closest_hit_bwd)


def _roots(d, oc, r, a):
    """Both roots of the sphere quadratic along ``d``, and ``q = r^2 - l^2``
    (``disc / a``; a hit needs q >= 0).

    ``d`` and ``oc = c - o`` are 3-tuples of components; every argument
    broadcasts (per pair (R, N) in the closest-hit reduction, per winner
    (R,) in the replay). Geometric form: the ray passes the center at
    ``tc = h / a`` at distance ``l = |oc - tc d|``, and the roots are
    ``tc -/+ sqrt(q / a)``. Unlike ``h^2 - a c``, ``r^2 - l^2`` cancels only
    for grazing rays, so small distant spheres keep t to ~1e-7 relative."""
    h = d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2]
    tc = h / a
    lx, ly, lz = (oc[k] - tc * d[k] for k in range(3))
    q = r * r - (lx * lx + ly * ly + lz * lz)
    # Double-where so reverse-mode AD never sees d(sqrt)/dx at x<=0 = inf
    # (inf * 0 = NaN would poison camera/geometry gradients).
    pos = q > 0.0
    s = jnp.where(pos, jnp.sqrt(jnp.where(pos, q, 1.0) / a), 0.0)
    return tc - s, tc + s, q


def sphere_roots(o, d, c, r):
    """Per-ray roots against one sphere each: o, d, c (R, 3), r (R,) ->
    (near root, far root, q) as in :func:`_roots`."""
    return _roots(
        tuple(d[:, k] for k in range(3)),
        tuple(c[:, k] - o[:, k] for k in range(3)),
        r,
        jnp.sum(d * d, axis=-1),
    )


def _closest_root(o, d, cx, cy, cz, r, act, t_min, t_max):
    """Closest accepted root over the sphere axis -> (t, idx, hit).

    ``cx``/``cy``/``cz``/``r``/``act`` are (1, N) for a static table or
    (R, N) for per-ray geometry; each pair forms its own ``oc = c - o``."""
    root0, root1, q = _roots(
        tuple(d[:, k : k + 1] for k in range(3)),
        (cx - o[:, 0:1], cy - o[:, 1:2], cz - o[:, 2:3]),
        r,
        jnp.sum(d * d, axis=-1)[:, None],
    )
    ok0 = (root0 > t_min) & (root0 < t_max)
    ok1 = (root1 > t_min) & (root1 < t_max)
    root = jnp.where(ok0, root0, root1)
    valid = (q >= 0.0) & (ok0 | ok1) & act
    t, idx = min_with_index(jnp.where(valid, root, BIG))
    return t, idx, t < BIG


def _hit_spheres_impl(o, d, centers, radii, active, t_min, t_max):
    if centers.ndim == 2:
        c, r, act = centers[None], radii[None, :], active[None, :]
    else:
        # Exact-motion path: per-ray centers (R, N, 3).
        c, r = centers, radii
        act = active if active.ndim == 2 else active[None, :]
    return _closest_root(
        o, d, c[..., 0], c[..., 1], c[..., 2], r, act, t_min, t_max
    )


def hit_spheres_moving(o, d, w, ca, cd, ra, rd, active, t_min, t_max):
    """Closest hit against linearly-moving spheres.

    Motion model: center(w) = ca + w*cd, radius(w) = ra + w*rd with the
    per-ray shutter fraction w in [0,1] (models/timeline.py linear-shutter
    lowering; the reference instead re-evaluates the whole timeline per ray,
    src/objects/sphere.rs:67-69 — identical for piecewise-linear tracks with
    no keyframe inside the frame's shutter window).

    Each pair lerps its center and radius at its ray's w inside the fused
    reduction, so the animated path adds one multiply-add per coordinate
    and builds no (R, N, 3) tensor.

    Differentiable with an O(R) winner-only backward (custom VJP mirroring
    hit_spheres): dt/d(ca) = nvec/den per winner, the motion leaves pick up
    an extra factor w (dt/d(cd) = w * nvec/den, dt/d(rd) = w * r(w)/den).
    The shutter fraction w itself is an RNG sample (detached).

    Args: o, d (R,3); w (R,); ca/cd (N,3); ra/rd (N,); active (N,) bool.
    Returns (t, idx, hit) like hit_spheres.
    """
    return _moving_hit(
        o, d, w, ca, cd, ra, rd,
        jnp.asarray(active).astype(jnp.float32),
        jnp.asarray(t_min, jnp.float32),
        jnp.asarray(t_max, jnp.float32),
    )


@jax.custom_vjp
def _moving_hit(o, d, w, ca, cd, ra, rd, active_f, t_min, t_max):
    return _moving_hit_impl(o, d, w, ca, cd, ra, rd, active_f, t_min, t_max)


def _moving_hit_fwd(o, d, w, ca, cd, ra, rd, active_f, t_min, t_max):
    out = _moving_hit_impl(o, d, w, ca, cd, ra, rd, active_f, t_min, t_max)
    t, idx, hit = out
    return out, (o, d, w, ca, cd, ra, rd, t, idx, hit)


def _moving_hit_bwd(res, cts):
    o, d, w, ca, cd, ra, rd, t, idx, hit = res
    t_bar = cts[0]
    c_w = jnp.take(ca, idx, axis=0) + w[:, None] * jnp.take(cd, idx, axis=0)
    r_w = jnp.take(ra, idx, axis=0) + w * jnp.take(rd, idx, axis=0)
    t_safe = jnp.where(hit, t, 1.0)
    nvec = o + t_safe[:, None] * d - c_w
    den = jnp.sum(d * nvec, axis=-1)
    safe_den = jnp.where(jnp.abs(den) > 1e-12, den, 1.0)
    g = jnp.where(hit & (jnp.abs(den) > 1e-12), t_bar / safe_den, 0.0)
    go = -g[:, None] * nvec
    gd = -(g * t_safe)[:, None] * nvec
    gc_rows = jnp.where(hit[:, None], g[:, None] * nvec, 0.0)
    gr_rows = jnp.where(hit, g * r_w, 0.0)
    gca = jnp.zeros_like(ca).at[idx].add(gc_rows)
    gcd = jnp.zeros_like(cd).at[idx].add(w[:, None] * gc_rows)
    gra = jnp.zeros_like(ra).at[idx].add(gr_rows)
    grd = jnp.zeros_like(rd).at[idx].add(w * gr_rows)
    zero = jnp.zeros((), jnp.float32)
    # w is an RNG sample: detached (its true derivative moves the shutter
    # instant, a term the detached-sampling estimator excludes).
    return (
        go, gd, jnp.zeros_like(w), gca, gcd, gra, grd,
        jnp.zeros_like(ca[:, 0]), zero, zero,
    )


_moving_hit.defvjp(_moving_hit_fwd, _moving_hit_bwd)


def _moving_hit_impl(o, d, w, ca, cd, ra, rd, active_f, t_min, t_max):
    wcol = w[:, None]  # (R, 1)
    cx, cy, cz = (ca[None, :, k] + wcol * cd[None, :, k] for k in range(3))
    return _closest_root(
        o, d, cx, cy, cz, ra[None, :] + wcol * rd[None, :],
        (active_f > 0.0)[None, :], t_min, t_max,
    )


def sphere_uv(n):
    """(u, v) texture coordinates from the unit outward normal.

    Reference: src/objects/sphere.rs:41-46 — theta = acos(-y),
    phi = atan2(-z, x) + pi; u = phi/2pi, v = theta/pi.
    """
    from crucible_tpu.utils.vec import safe_arccos, safe_arctan2

    theta = safe_arccos(-n[..., 1])
    phi = safe_arctan2(-n[..., 2], n[..., 0]) + jnp.pi
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def hit_triangles(o, d, v0, v1, v2, active, t_min, t_max, v0d=None, v1d=None, v2d=None, w=None):
    """Closest triangle hit per ray via batched Möller–Trumbore.

    Args:
      o, d: (R, 3); v0/v1/v2: (M, 3) or (R, M, 3) (animated); active: (M,).
      v0d/v1d/v2d, w: optional linear shutter motion (vertex + w * delta,
        per-ray w) — the brute-force path materializes (R, M, 3) so keep M
        small here; the BVH path (ops/traverse.py) lerps per leaf instead.

    Returns (t, idx, hit) like :func:`hit_spheres`. Barycentrics are
    recomputed at shading time for the winner only.
    """
    if v0.ndim == 2:
        v0b, v1b, v2b = v0[None], v1[None], v2[None]  # (1, M, 3)
    else:
        v0b, v1b, v2b = v0, v1, v2
    if v0d is not None:
        wb = w[:, None, None]
        v0b = v0b + wb * v0d[None]
        v1b = v1b + wb * v1d[None]
        v2b = v2b + wb * v2d[None]
    e1 = v1b - v0b
    e2 = v2b - v0b
    ob = o[:, None, :]
    db = d[:, None, :]

    pvec = jnp.cross(db, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > MT_EPS, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = ob - v0b
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(db * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det

    valid = (
        (jnp.abs(det) > MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
        & (active if active.ndim == 2 else active[None, :])
    )
    t_best, idx = min_with_index(jnp.where(valid, t, BIG))
    return t_best, idx, t_best < BIG


def triangle_normal(v0, v1, v2):
    """Geometric normal e1 x e2, normalized (reference uses
    HitRecord::safe_new which normalizes, src/objects/triangle.rs:120-140)."""
    n = jnp.cross(v1 - v0, v2 - v0)
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def hit_aabbs(o, d, box_min, box_max, t_min, t_max):
    """Batched slab test: R rays x K boxes.

    Reference: Aabb::hit (src/objects/bvh.rs:96-132) iterates axes with
    early-out; here all axes and boxes evaluate in parallel and the interval
    intersection is a max/min reduction.

    Args: o, d (R,3); box_min/box_max (K,3). Returns (R, K) bool.
    """
    # Avoid 0 * inf = nan when a ray is axis-aligned AND starts on a slab
    # plane: nudge zero components to a tiny signed epsilon instead.
    d_safe = jnp.where(jnp.abs(d) < 1e-30, jnp.where(d >= 0, 1e-30, -1e-30), d)
    inv_d = 1.0 / d_safe
    t0 = (box_min[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (box_max[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return enter < exit_
