"""Record/replay differentiable path tracing — the fast gradient path.

The reference's hot loop (src/camera/ray_casting.rs:112-152) is a recursive
product of attenuations; its batched counterpart is the wavefront
integrator. Differentiating that forward directly (models/integrator.trace
with ``differentiable=True``) is correct but slow: the ``jax.checkpoint``
re-forward re-runs the full candidate intersection every bounce, and every
per-winner ``jnp.take`` transposes into a scatter-add.

This module splits the work in two:

1. ``trace_record`` — the FAST, non-differentiable forward. Runs the
   lockstep wavefront (early-exit while_loop, fused closest-hit reduction)
   and records, per bounce, only the discrete outcomes: winner
   primitive id (int32) and a bitmask (alive/hit/tri/scattered/front/
   reflect/degenerate/root1). Integers carry no tangents, so the records
   detach exactly the decisions the gradient stance already detached
   (models/integrator.py docstring).

2. ``trace_replay`` — the differentiable REPLAY. A static scan that
   re-derives every continuous quantity from the records alone: the hit t
   as the recorded root of the winning sphere's quadratic (an implicit
   function of center/radius/ray — same estimator as the custom VJP in
   ops/intersect.py), normals, albedos, scatter directions (RNG uniforms
   are pure pcg4d hashes, recomputed bit-identically). Per-bounce work is
   O(R) — no candidate matrices, no argmin — and all per-winner attribute
   fetches go through ONE one-hot matmul per table (ops/gather.take_rows_mm),
   whose backward is another matmul instead of a scatter-add.

Gradients are mathematically identical to the detached-sampling estimator
of the direct-AD path (same frozen decisions, same continuous tape);
radiance values agree with :func:`integrator.trace` up to f32 association
(the replay recomputes t per winner instead of via the (R, N) matmul).

Replay also differentiates what direct AD could not do cheaply: animated
(linearly-moving) spheres — center(w) = c + w*cd enters the replayed
quadratic, so motion gradients flow with no (R, N, 3) rematerialization —
and triangle-mesh hits via per-winner Möller–Trumbore recomputation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from crucible_tpu.models import integrator
from crucible_tpu.models import materials as mat_mod
from crucible_tpu.models import skybox as sky_mod
from crucible_tpu.models import textures as tex_mod
from crucible_tpu.models.camera import CameraParams, generate_rays
from crucible_tpu.models.scene import SceneData
from crucible_tpu.ops import intersect
from crucible_tpu.ops.gather import take_rows_mm
from crucible_tpu.utils import rng as crng
from crucible_tpu.utils import vec

T_MIN = integrator.T_MIN

# Per-bounce decision bits — the low BYTE of the packed record word.
F_ALIVE = 1  # lane had an in-flight path entering this bounce
F_HIT = 2  # the path hit a primitive (else: sky)
F_TRI = 4  # winner is a triangle (else: sphere)
F_SCAT = 8  # path continued (hit & material scattered)
F_FRONT = 16  # front-face flag (HitRecord convention)
F_REFL = 32  # dielectric chose reflection over refraction
F_DEGEN = 64  # Lambertian scatter direction was degenerate
F_ROOT1 = 128  # sphere hit used the far quadratic root

# Packed record word (ONE int32 per bounce per lane — halves record traffic
# and doubles the spp per record-budget chunk vs the r2 two-word layout):
#   bits 0..7   flag byte (F_* above)
#   bits 8..30  winner primitive id when F_HIT (0 otherwise); ids < 2^23
# The word is always non-negative, so arithmetic and logical right shifts
# agree. Flag tests work directly on the packed word since all F_* < 256.
REC_ID_SCALE = 256


# Winner ids must fit bits 8..30 of the int32 record word; beyond this the
# packed word overflows into the sign bit and shift_right_logical decodes a
# garbage id (silently wrong radiance/gradients). Enforced loudly at every
# record entry point (ADVICE r3).
REC_MAX_IDS = 1 << 23


def _check_record_capacity(sd: SceneData) -> None:
    n_sph = int(sd.sph_center.shape[0])  # padded table rows (the id space)
    if sd.num_tris >= REC_MAX_IDS or n_sph >= REC_MAX_IDS:
        raise ValueError(
            f"scene exceeds the packed-record id capacity (2^23): "
            f"{sd.num_tris} triangles / {n_sph} sphere rows — the record/"
            f"replay gradient path cannot represent winner ids this large"
        )


def pack_record(win_id, flags):
    """Assemble packed words from (R,) winner ids (already masked to hit
    rows) and (R,) int32 flag words."""
    return win_id.astype(jnp.int32) * jnp.int32(REC_ID_SCALE) + flags


def rec_winner_id(rec):
    """Winner primitive id column of packed records (any shape)."""
    return jax.lax.shift_right_logical(rec, 8)


def replay_supported(sd: SceneData) -> bool:
    """Static predicate — True for every scene the framework can build.

    As of r4 exact per-ray-time scenes (mid-shutter keyframes) are
    replayable too: the replay re-derives winner geometry from the
    piecewise-linear timeline tracks evaluated at the lane's absolute time
    (integrator.exact_sphere_winner / exact_tri_vertices), matching the
    record pass's staged bounce_step. Moving triangle meshes (per-winner
    vertex lerp) and arbitrarily nested checkers (full textures.value
    resolution) have been replayable since r3. The predicate is kept as
    the single routing point should a future scene feature outrun the
    replay."""
    return True


def _pack(**bits):
    """Assemble the int32 flag word from named (R,) bools."""
    word = None
    masks = dict(
        alive=F_ALIVE, hit=F_HIT, tri=F_TRI, scat=F_SCAT, front=F_FRONT,
        refl=F_REFL, degen=F_DEGEN, root1=F_ROOT1,
    )
    for name, b in bits.items():
        term = jnp.where(b, jnp.int32(masks[name]), jnp.int32(0))
        word = term if word is None else word | term
    return word


def trace_record(
    sd: SceneData,
    o,
    d,
    pixel_ids,
    sample_ids,
    seed,
    max_depth: int,
):
    """Fast non-differentiable forward -> per-bounce decision records.

    Returns packed records (D, R) int32 (winner id * 256 + flag byte).
    Rows past the wavefront's death are all-zero (F_ALIVE clear).
    """
    _check_record_capacity(sd)
    r = o.shape[0]
    rec0 = jnp.zeros((max_depth, r), jnp.int32)

    if sd.animated:
        w = crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)
    else:
        w = None
    t_ray = (
        sd.motion_t0 + w * (sd.motion_t1 - sd.motion_t0)
        if sd.motion_exact
        else None
    )

    def body(state):
        bounce, o_c, d_c, alive, recbuf = state
        s = integrator.bounce_step(
            sd, o_c, d_c, pixel_ids, sample_ids, bounce, seed,
            return_decisions=True,
        )
        hit = alive & s["hit"]
        is_tri = s["is_tri"]
        i_s = s["i_sph"]

        # Which quadratic root the winning sphere hit used — recomputed with
        # the same per-winner math the replay will use, so the bit and the
        # replayed t are self-consistent (src/objects/sphere.rs:84-94: near
        # root preferred, far root if the near one is outside the interval).
        if sd.motion_exact:
            c_w, r_w = integrator.exact_sphere_winner(sd, i_s, t_ray)
        else:
            c_w = jnp.take(sd.sph_center, i_s, axis=0)
            r_w = jnp.take(sd.sph_radius, i_s, axis=0)
            if sd.animated:
                c_w = c_w + w[:, None] * jnp.take(sd.sph_center_d, i_s, axis=0)
                r_w = r_w + w * jnp.take(sd.sph_radius_d, i_s, axis=0)
        root0, _, _ = intersect.sphere_roots(o_c, d_c, c_w, r_w)
        root1 = ~(root0 > T_MIN)

        cont = hit & s["scattered"]
        flags = _pack(
            alive=alive, hit=hit, tri=is_tri & hit, scat=cont,
            front=s["front"], refl=s["decisions"]["reflect"],
            degen=s["decisions"]["degenerate"], root1=root1 & ~is_tri,
        )
        win = jnp.where(is_tri, s["i_tri"], i_s).astype(jnp.int32)
        word = pack_record(jnp.where(hit, win, 0), flags)
        recbuf = jax.lax.dynamic_update_slice(recbuf, word[None], (bounce, 0))

        o_c = jnp.where(cont[:, None], s["new_o"], o_c)
        d_c = jnp.where(cont[:, None], s["new_d"], d_c)
        return bounce + 1, o_c, d_c, cont, recbuf

    def cond(state):
        bounce, _, _, alive, _ = state
        return (bounce < max_depth) & jnp.any(alive)

    alive0 = jnp.ones((r,), bool)
    state = (jnp.int32(0), o, d, alive0, rec0)
    *_, recbuf = jax.lax.while_loop(cond, body, state)
    return recbuf


def trace_replay(
    sd: SceneData,
    o,
    d,
    pixel_ids,
    sample_ids,
    seed,
    max_depth: int,
    rec,
    early_exit: bool = False,
    bounce0: int = 0,
    thr_in=None,
    return_carry: bool = False,
    accum_from: int = 0,
):
    """Differentiable O(R * depth) replay of recorded decisions -> (R, 3).

    ``early_exit=True`` walks only the record rows that still carry a live
    lane (a while_loop over the row prefix — forward-only, since while has
    no transpose rule). Worth ~depth/mean-path-length on deep-budget scenes
    (depth 50 with ~3-bounce means); the gradient path keeps the static
    scan.

    ``bounce0``/``thr_in``/``return_carry`` support SPLIT replays (the
    head/tail lane-narrowing in _record_replay_chunk): records may be a row
    slice starting at absolute bounce ``bounce0`` (keeps the per-bounce RNG
    streams aligned), ``thr_in`` seeds the throughput carry, and
    ``return_carry=True`` additionally returns (o, d, thr) after the last
    replayed row.

    ``accum_from``: rows with absolute bounce index below it update the
    path carry (origin/direction/throughput) but add NOTHING to radiance —
    the depth-bucketed replay re-walks a lane's head rows from the primary
    ray instead of gathering float carries across a compaction boundary
    (see :func:`replay_bucketed`).
    """
    r = o.shape[0]
    table = integrator.make_sphere_table(sd)  # (N, 31), differentiable
    if sd.num_tris > 0:
        mats = integrator.make_mat_table(sd)  # (L, 19)
    else:
        mats = None
    if sd.animated:
        w = crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)
    else:
        w = None
    # Exact per-ray-time scenes (mid-shutter keyframes): winner geometry is
    # re-derived from the piecewise-linear timeline tracks at the lane's
    # absolute time — same math as the record pass's bounce_step, so the
    # recorded decisions and the replayed t stay self-consistent
    # (src/timeline/mod.rs:233-263 evaluated per ray).
    t_ray = (
        sd.motion_t0 + w * (sd.motion_t1 - sd.motion_t0)
        if sd.motion_exact
        else None
    )

    n_imgs = len(sd.tex.images)

    @jax.checkpoint
    def step(carry, xs):
        o_c, d_c, thr, rad = carry
        word, bounce = xs
        flags = word  # flag byte tests work on the packed word (F_* < 256)
        idx = rec_winner_id(word)
        alive = (flags & F_ALIVE) > 0
        hit = (flags & F_HIT) > 0
        is_tri = (flags & F_TRI) > 0
        cont = (flags & F_SCAT) > 0
        front = (flags & F_FRONT) > 0
        refl = (flags & F_REFL) > 0
        degen = (flags & F_DEGEN) > 0
        root1 = (flags & F_ROOT1) > 0

        # --- winner attribute fetch: ONE one-hot matmul per table ----------
        srow = take_rows_mm(table, jnp.where(is_tri, 0, idx))  # (R, 32)
        c_w = srow[:, 0:3]
        r_w = srow[:, 3]
        if sd.motion_exact:
            c_w, r_w = integrator.exact_sphere_winner(
                sd, jnp.where(is_tri, 0, idx), t_ray
            )
        elif sd.animated:
            c_w = c_w + w[:, None] * srow[:, 24:27]
            r_w = r_w + w * srow[:, 27]

        # Hit t as the recorded root of the winner's quadratic — the same
        # implicit-function estimator as ops/intersect.py's custom VJP, but
        # on the primal tape (autodiff differentiates the closed form).
        near, far, _ = intersect.sphere_roots(o_c, d_c, c_w, r_w)
        t_sph = jnp.where(root1, far, near)

        if sd.num_tris > 0:
            ti = jnp.where(is_tri, idx, 0)
            if sd.tri_exact:
                # Exact per-ray-time vertices from the winner's timeline
                # tracks (leaf order for BVH meshes) — the replay-side
                # mirror of the traversal's vertex_fn leaf evaluation.
                v0, v1, v2 = integrator.exact_tri_vertices(sd, ti, t_ray)
            else:
                v0 = jnp.take(sd.tri_v0, ti, axis=0)
                v1 = jnp.take(sd.tri_v1, ti, axis=0)
                v2 = jnp.take(sd.tri_v2, ti, axis=0)
                if sd.animated and sd.tri_v0_d is not None:
                    # Per-winner vertex motion lerp at the lane's shutter
                    # fraction — same pattern as the sphere motion columns;
                    # mirrors the per-vertex timelines of
                    # src/objects/triangle.rs:15-17 under the linear-shutter
                    # model. Motion gradients flow through the replayed MT.
                    v0 = v0 + w[:, None] * jnp.take(sd.tri_v0_d, ti, axis=0)
                    v1 = v1 + w[:, None] * jnp.take(sd.tri_v1_d, ti, axis=0)
                    v2 = v2 + w[:, None] * jnp.take(sd.tri_v2_d, ti, axis=0)
            # Per-winner Möller–Trumbore t (src/objects/triangle.rs:84-140).
            e1 = v1 - v0
            e2 = v2 - v0
            pvec = jnp.cross(d_c, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
            qvec = jnp.cross(o_c - v0, e1)
            t_tri = jnp.sum(e2 * qvec, axis=-1) * inv_det
            n_tri = intersect.triangle_normal(v0, v1, v2)
            mrow = take_rows_mm(mats, jnp.take(sd.tri_mat, ti, axis=0))
            t_hit = jnp.where(is_tri, t_tri, t_sph)

            def attr(c):  # sphere table column c; mats stores c-6
                return jnp.where(is_tri, mrow[:, c - 6], srow[:, c])

            def attr3(c):
                return jnp.where(
                    is_tri[:, None], mrow[:, c - 6 : c - 3], srow[:, c : c + 3]
                )
        else:
            t_hit = t_sph
            n_tri = None

            def attr(c):
                return srow[:, c]

            def attr3(c):
                return srow[:, c : c + 3]

        t_shade = jnp.where(hit, t_hit, 1.0)
        point = o_c + t_shade[:, None] * d_c
        n_sph = (point - c_w) / jnp.maximum(r_w, 1e-20)[:, None]
        n_out = jnp.where(is_tri[:, None], n_tri, n_sph) if n_tri is not None else n_sph
        normal = jnp.where(front[:, None], n_out, -n_out)

        # --- radiance: sky on miss, emission on hit -------------------------
        sky = sky_mod.radiance(sd.sky_kind, sd.sky_image, d_c)
        emission = attr3(10)
        contrib = jnp.where(hit[:, None], emission, sky)
        live = (
            alive if accum_from <= 0
            else alive & (bounce >= jnp.int32(accum_from))
        )
        rad = rad + jnp.where(live[:, None], thr * contrib, 0.0)

        # --- albedo: solid / checker / image (models/textures.py) ----------
        if n_imgs or sd.tex.max_nest > 1:
            # Full texture-table evaluation: resolves max_nest checker
            # levels (each with ITS OWN inv_scale parity) and the scene's
            # images — textures.value is the single semantic source
            # (src/textures/checker_texture.rs:39-52 recursion). Integer
            # takes carry no tangents; the texel gather IS the texel
            # gradient.
            if sd.num_tris > 0:
                tid = jnp.where(is_tri, mrow[:, 18], srow[:, 30])
            else:
                tid = srow[:, 30]
            tid = tid.astype(jnp.int32)
            u_s, v_s = intersect.sphere_uv(n_sph)
            if sd.num_tris > 0:
                # Triangle uv is hardcoded (0,0) (triangle.rs:133-134).
                u_s = jnp.where(is_tri, 0.0, u_s)
                v_s = jnp.where(is_tri, 0.0, v_s)
            albedo = tex_mod.value(sd.tex, tid, u_s, v_s, point)
        else:
            # Fast path (solid / one-level checker): colors ride the
            # already-fetched winner row — no extra gathers.
            inv_scale = attr(17)
            xyz = jnp.floor(inv_scale[:, None] * point).astype(jnp.int32)
            is_even = (xyz[:, 0] + xyz[:, 1] + xyz[:, 2]) % 2 == 0
            kind = attr(13)
            checker = jnp.where(is_even[:, None], attr3(18), attr3(21))
            albedo = jnp.where(
                (kind == np.float32(tex_mod.CHECKER))[:, None], checker, attr3(14)
            )

        # --- scatter with frozen decisions ----------------------------------
        u1, u2, u_dec = crng.uniform3(
            pixel_ids,
            sample_ids,
            jnp.uint32(crng.STREAM_BOUNCE_BASE) + bounce.astype(jnp.uint32),
            seed,
        )
        new_dir, atten, _ = mat_mod.scatter(
            attr(6).astype(jnp.int32),
            attr(7),
            attr(8),
            attr(9),
            albedo,
            d_c,
            normal,
            front,
            u1,
            u2,
            u_dec,
            forced_reflect=refl,
            forced_degenerate=degen,
        )
        thr = jnp.where(cont[:, None], thr * atten, thr)
        o_c = jnp.where(cont[:, None], point, o_c)
        d_c = jnp.where(cont[:, None], new_dir, d_c)
        return (o_c, d_c, thr, rad), None

    thr0 = jnp.ones((r, 3), jnp.float32) if thr_in is None else thr_in
    rad0 = jnp.zeros((r, 3), jnp.float32)
    if early_exit:
        # Alive rows form a prefix (the record loop stops when every lane
        # died), so the live row count bounds the walk.
        live_rows = jnp.sum(
            jnp.any((rec & F_ALIVE) > 0, axis=1).astype(jnp.int32)
        )

        def cond(st):
            return st[0] < live_rows

        def body(st):
            b, carry = st[0], st[1]
            word = jax.lax.dynamic_slice_in_dim(rec, b, 1, axis=0)[0]
            carry, _ = step(carry, (word, b + jnp.int32(bounce0)))
            return (b + 1, carry)

        _, (o_c, d_c, thr, rad) = jax.lax.while_loop(
            cond, body, (jnp.int32(0), (o, d, thr0, rad0))
        )
        if return_carry:
            return rad, (o_c, d_c, thr)
        return rad
    bounces = jnp.int32(bounce0) + jnp.arange(max_depth, dtype=jnp.int32)
    (o_c, d_c, thr, rad), _ = jax.lax.scan(
        step, (o, d, thr0, rad0), (rec, bounces)
    )
    if return_carry:
        return rad, (o_c, d_c, thr)
    return rad


# Head/tail replay split: rows 0..split_depth-1 replay at full lane width;
# lanes still alive past that are stream-compacted (prefix-sum rank +
# drop-mode scatter) to an R/long_div budget, so the deep tail stops
# paying full-width row costs (earthprof_400w: 50 live rows, replay
# 0.301 s of a 0.339 s chunk).
# Forward (deep-budget scenes, depth 50, ~1e-4 of lanes survive row 8):
SPLIT_DEPTH = 8
LONG_DIV = 64
# Shallow-split parameters: NOT on the production path (at depth ~8 the
# compaction gathers cost more than the 6 rows they save — BASELINE.md
# negative results); kept as the exercised configuration of the
# split-vs-unsplit bit-exactness test (tests/test_replay.py).
GRAD_SPLIT_DEPTH = 2
GRAD_LONG_DIV = 4
# Budgets at or below this replay unsplit in the gradient path (the
# compaction gathers cost more than the few rows they save).
GRAD_SPLIT_MIN_DEPTH = 12
# Static narrow passes in the differentiable tail (capacity = TAIL_PASSES /
# GRAD_LONG_DIV of all lanes; overflow poisons the result with NaN — loud,
# never silently biased).
TAIL_PASSES = 2
# Deep-budget gradients (depth 50) use ONE wider split instead: head
# GRAD_DEEP_SPLIT_DEPTH rows full width, the remaining rows at
# r/GRAD_DEEP_LONG_DIV x TAIL_PASSES. (A recursive re-split every 6 rows
# was tried first: ~8 nested scan levels at depth 50 ballooned the remote
# compile past 30 minutes.) Capacity 2/16 = 12.5% of lanes vs the ~2.2%
# that survive row 8 on book1 — a 5.7x margin.
GRAD_DEEP_SPLIT_DEPTH = 8
GRAD_DEEP_LONG_DIV = 16


def replay_split(
    sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec,
    *, split_depth, long_div, early_exit, bounce0=0, thr_in=None,
):
    """Head/tail lane-narrowed replay -> radiance (R, 3).

    Rows 0..k-1 replay at full width; lanes whose record depth exceeds k
    are compacted to an R/long_div budget for the remaining rows, with a
    full-width lax.cond fallback when more lanes survive. Compaction is a
    prefix-sum enumeration + drop-mode scatter of lane ids — O(R), no sort
    (a top_k over millions of lanes costs more than the rows it saves). Differentiable end-to-end when ``early_exit=False`` (static
    scans; the indices are integers, the gather/scatter-add pair transposes
    exactly), so the gradient path shares it (``early_exit=True`` keeps the
    forward-only while_loop row walk).

    Bit-exact vs the unsplit replay: the head/tail carries hand off in the
    same f32 order, and non-selected lanes' tail rows are dead (flag 0).
    """
    k = min(split_depth, max_depth)
    if max_depth <= k + 2:
        return trace_replay(
            sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec,
            early_exit=early_exit, bounce0=bounce0, thr_in=thr_in,
        )
    r = o.shape[0]
    r_long = int(min(r, max(512, r // long_div)))
    rad_head, (o_k, d_k, thr_k) = trace_replay(
        sd, o, d, pixel_ids, sample_ids, seed, k, rec[:k], return_carry=True,
        bounce0=bounce0, thr_in=thr_in,
    )
    depth_lane = jnp.sum(((rec & F_ALIVE) > 0).astype(jnp.int32), axis=0)
    long_flag = depth_lane > k
    n_long = jnp.sum(long_flag.astype(jnp.int32))
    rank = jnp.cumsum(long_flag.astype(jnp.int32)) - 1  # deep lane -> rank

    def tail_pass(rank_lo):
        """Replay ranks [rank_lo, rank_lo + r_long) of the deep lanes."""
        pos = rank - rank_lo
        in_pass = long_flag & (pos >= 0) & (pos < r_long)
        slot = jnp.where(in_pass, pos, r_long)  # r_long = out of bounds
        idx = (
            jnp.zeros((r_long,), jnp.int32)
            .at[slot]
            .set(jnp.arange(r, dtype=jnp.int32), mode="drop")
        )
        # Unfilled slots alias lane 0; zero their throughput so they
        # replay to exactly nothing (value and gradient).
        valid = (
            jnp.arange(r_long, dtype=jnp.int32) < n_long - rank_lo
        )
        thr_sel = jnp.where(valid[:, None], jnp.take(thr_k, idx, axis=0), 0.0)
        tail_args = (
            sd,
            jnp.take(o_k, idx, axis=0),
            jnp.take(d_k, idx, axis=0),
            jnp.take(pixel_ids, idx, axis=0),
            jnp.take(sample_ids, idx, axis=0),
            seed,
            max_depth - k,
            jnp.take(rec[k:], idx, axis=1),
        )
        rad_l = trace_replay(
            *tail_args, early_exit=early_exit, bounce0=bounce0 + k,
            thr_in=thr_sel,
        )
        return jnp.zeros((r, 3), jnp.float32).at[idx].add(rad_l)

    if early_exit:
        # Forward-only: a full-width while_loop fallback is cheap to carry
        # (no reverse-mode residuals), so one narrow pass + cond guard.
        def tail_full(_):
            return trace_replay(
                sd, o_k, d_k, pixel_ids, sample_ids, seed, max_depth - k,
                rec[k:], early_exit=True, bounce0=bounce0 + k, thr_in=thr_k,
            )

        rad_tail = jax.lax.cond(
            n_long <= r_long, lambda _: tail_pass(0), tail_full, None
        )
        return rad_head + rad_tail

    # Differentiable path: NO lax.cond — a full-width scan branch forces
    # XLA to materialize its stacked checkpoint residuals in a copy whose
    # {2,1,0:T(8,128)} layout pads the minor dim of 3 to 128 (21 GB at
    # 1080p — the OOM that killed the r2-style guard). Instead run a
    # STATIC number of narrow passes (capacity TAIL_PASSES * r/long_div
    # deep lanes — 50% of lanes at the defaults, ~2.8x the measured book1
    # survivor fraction past row 2) and poison the result with NaN if
    # capacity is ever exceeded: a loud failed-finite check downstream
    # instead of a silently biased gradient.
    rad_tail = tail_pass(0)
    for p in range(1, TAIL_PASSES):
        rad_tail = rad_tail + tail_pass(p * r_long)
    dropped = n_long - TAIL_PASSES * r_long
    rad_tail = jnp.where(dropped > 0, jnp.float32(jnp.nan), rad_tail)
    return rad_head + rad_tail


# Depth-bucketed replay (the r4 deep-budget gradient path). Spec entries
# are (depth_limit, width_divisor); the first bucket is the full-width head,
# a limit of 0 stretches to max_depth. Divisor capacities carry the same
# NaN-overflow-guard contract as replay_split (loud, never silently biased).
# Shipped spec (gradprof50c sweep, book1 1080p x 4spp d50 full chunks):
#   (6:1, 16:16, 0:32) = 1.531 s — the mid bucket compacts ON THE NARROW
#   RECORD, so its extra compaction is cheap; margins 6.25%/3.3% (1.9x)
#   and 3.1%/0.71% (4.4x) vs the depth histogram.
# Sweep history: 2-bucket (6:1,0:16) 1.587-1.668; head-8 variants 1.94;
# head-4 + mid 1.719 (shorter head loses); div-24 tails 1.51 but at a
# 1.04x capacity margin (rejected); r3 carry-handoff split 2.099 on the
# same records. Escape hatch for high-survivor scenes: split=False /
# CRUCIBLE_GRAD_SPLIT=0; spec override CRUCIBLE_GRAD_BUCKETS.
GRAD_BUCKET_SPEC = ((6, 1), (16, 16), (0, 32))


def _bucket_spec(max_depth: int, spec=None):
    """Normalize the bucket spec against ``max_depth``: clip limits, drop
    now-empty buckets, stretch the last to max_depth. Override with the
    ``CRUCIBLE_GRAD_BUCKETS`` env var ("8:1,16:8,0:32")."""
    import os

    if spec is None:
        env = os.environ.get("CRUCIBLE_GRAD_BUCKETS")
        if env:
            spec = tuple(
                (int(a), int(b))
                for a, b in (part.split(":") for part in env.split(","))
            )
        else:
            spec = GRAD_BUCKET_SPEC
    lims, divs = [], []
    for lim, dv in spec:
        lim = max_depth if lim <= 0 else min(lim, max_depth)
        if lims and lim <= lims[-1]:
            continue
        lims.append(lim)
        divs.append(dv)
    lims[-1] = max_depth
    return lims, divs


def replay_bucketed(
    sd, cp, width, height, o, d, pixel_ids, sample_ids, seed, max_depth, rec,
    *, spec=None, passes: int = 1,
):
    """Depth-bucketed differentiable replay -> radiance (R, 3).

    The record pass makes every lane's path depth known data, so the deep
    tail never has to run full width: lanes are partitioned by depth into
    static scan lengths (bucket 0 full width over the head rows; deeper
    buckets stream-compacted to r/div lanes and scanned to their limit).
    This sidesteps the "static scans can't early-exit under reverse-mode"
    wall of the bounce recursion being differentiated
    (src/camera/ray_casting.rs:112-152) without dynamic shapes.

    What it deliberately does NOT do (the r3 split's measured overhead):
    hand float carries across the compaction boundary: (R, 3) state gathers
    transpose to full-width scatter-adds in the backward pass. Instead a bucket re-walks
    its lanes' HEAD rows from the primary ray (regenerated bit-identically
    from the gathered integer pixel/sample ids — pcg4d streams are pure
    hashes) with radiance accumulation masked off below ``accum_from``; only
    integers cross the boundary. Head rows are cheap (bucket widths are
    narrow) and their recomputation IS the carry.

    Radiance identity with the unsplit replay: bucket 0 accumulates rows
    0..d0-1 for every lane; bucket j accumulates rows d0..dj-1 for exactly
    the lanes whose depth lands in (d(j-1), dj]. Per lane the two partial
    sums concatenate in row order, so values match the unsplit replay to
    f32 association (exactly, when at most one row contributes — miss-row
    sky with zero emission) and gradients match identically (same frozen
    decisions, same continuous ops).

    Overflow beyond a bucket's static capacity (``passes`` * r/div) poisons
    the result with NaN — loud, never silently biased.
    """
    lims, divs = _bucket_spec(max_depth, spec)
    r = o.shape[0]
    d0 = lims[0]
    rad = trace_replay(
        sd, o, d, pixel_ids, sample_ids, seed, d0, rec[:d0]
    )
    if len(lims) == 1:
        return rad
    depth_lane = jnp.sum(((rec & F_ALIVE) > 0).astype(jnp.int32), axis=0)
    for j in range(1, len(lims)):
        dj, dv = lims[j], divs[j]
        lo_lim = lims[j - 1]
        in_b = (depth_lane > lo_lim) & (depth_lane <= dj)
        n_b = jnp.sum(in_b.astype(jnp.int32))
        rank = jnp.cumsum(in_b.astype(jnp.int32)) - 1
        r_b = int(min(r, max(512, r // dv)))
        for p in range(passes):
            lo = p * r_b
            pos = rank - lo
            in_pass = in_b & (pos >= 0) & (pos < r_b)
            slot = jnp.where(in_pass, pos, r_b)  # r_b = dropped
            idx = (
                jnp.zeros((r_b,), jnp.int32)
                .at[slot]
                .set(jnp.arange(r, dtype=jnp.int32), mode="drop")
            )
            # Unfilled slots alias lane 0: zero their throughput so they
            # replay to exactly nothing (value and gradient).
            valid = jnp.arange(r_b, dtype=jnp.int32) < n_b - lo
            thr0 = jnp.where(
                valid[:, None], jnp.ones((r_b, 3), jnp.float32), 0.0
            )
            pix_b = jnp.take(pixel_ids, idx, axis=0)
            smp_b = jnp.take(sample_ids, idx, axis=0)
            # Regenerate primary rays in-bucket (bit-identical: pure pcg4d
            # streams keyed by the gathered ids); camera gradients flow
            # through this generate_rays exactly as through the head's.
            o_b, d_b, _ = generate_rays(cp, width, height, pix_b, smp_b, seed)
            rad_b = trace_replay(
                sd, o_b, d_b, pix_b, smp_b, seed, dj,
                jnp.take(rec[:dj], idx, axis=1),
                thr_in=thr0, accum_from=d0,
            )
            rad = rad.at[idx].add(
                jnp.where(valid[:, None], rad_b, 0.0), mode="drop"
            )
        dropped = n_b - passes * r_b
        rad = jnp.where(dropped > 0, jnp.float32(jnp.nan), rad)
    return rad


# Narrow re-record capacity for the two-level record: R/12 = 8.3% of lanes
# vs the 4.0% that survive the 6-row head on book1 (2.1x margin; overflow
# poisons loudly like every other static capacity here).
RECORD_DEEP_DIV = 12


def record_two_level(
    sd, cp, width, height, pixel_ids, sample_ids, seed, max_depth,
    head: int, div: int | None = None,
):
    """Two-level decision record: full width to ``head`` rows, then a
    NARROW re-record of only the surviving lanes to ``max_depth``.

    Why: a full-width record pays every row for every lane while the loop
    runs, and deep budgets run long tails — at the book1 north-star config
    0.45% of lanes run past row 32. Re-recording the ~2% survivors of the
    head at r/div width re-traces their paths from bounce 0 (decisions are
    a pure function of (pixel, sample, seed) — bit-identical), so the deep
    rows cost 1/div of full width.

    Returns (rec_h (head, R), rec_n (max_depth, r_n), idx_n (r_n,) lane
    ids, valid_n (r_n,) slot-filled mask, n_deep scalar). Overflow past
    r_n is detected by the caller via n_deep (NaN-poisoned downstream).
    ``div`` resolution: an explicit argument wins (the overflow-recovery
    ladder widens it, grad.loss_and_grad_recovering), else the
    ``CRUCIBLE_RECORD_DEEP_DIV`` env var (the sweep/test knob), else
    RECORD_DEEP_DIV.
    """
    import os

    r = pixel_ids.shape[0]
    if div is None:
        env_div = os.environ.get("CRUCIBLE_RECORD_DEEP_DIV")
        div = int(env_div) if env_div is not None else RECORD_DEEP_DIV

    def rec_pass(pix, smp, depth):
        o, d, _ = generate_rays(cp, width, height, pix, smp, seed)
        return trace_record(sd, o, d, pix, smp, seed, depth)

    rec_h = rec_pass(pixel_ids, sample_ids, head)
    cont = (rec_h[head - 1] & F_SCAT) > 0  # continued past the head rows
    n_deep = jnp.sum(cont.astype(jnp.int32))
    rank = jnp.cumsum(cont.astype(jnp.int32)) - 1
    r_n = int(min(r, max(512, r // div)))
    slot = jnp.where(cont & (rank < r_n), rank, r_n)
    idx_n = (
        jnp.zeros((r_n,), jnp.int32)
        .at[slot]
        .set(jnp.arange(r, dtype=jnp.int32), mode="drop")
    )
    valid_n = jnp.arange(r_n, dtype=jnp.int32) < n_deep
    pix_n = jnp.where(valid_n, jnp.take(pixel_ids, idx_n, axis=0), 0).astype(
        pixel_ids.dtype
    )
    # Unfilled slots get a sample id no real lane uses (2^30); their
    # records are traced but their bucket slots are masked by valid_n
    # downstream.
    smp_n = jnp.where(
        valid_n,
        jnp.take(sample_ids, idx_n, axis=0).astype(jnp.int32),
        jnp.int32(2**30),
    ).astype(sample_ids.dtype)
    rec_n = rec_pass(pix_n, smp_n, max_depth)
    return rec_h, rec_n, idx_n, valid_n, n_deep


def replay_bucketed_2l(
    sd, cp, width, height, o, d, pixel_ids, sample_ids, seed, max_depth,
    rec_h, rec_n, idx_n, valid_n, n_deep, *, spec=None, passes: int = 1,
):
    """Depth-bucketed replay over a TWO-LEVEL record (record_two_level).

    Identical estimator to :func:`replay_bucketed`; the difference is
    where the deep rows live: bucket 0 replays the full-width head record,
    and every deeper bucket compacts NARROW-record slots (r/div wide), so
    no full-width cumsum/scatter/gather runs beyond the one inside
    record_two_level. Narrow-capacity overflow poisons with NaN.
    """
    lims, divs = _bucket_spec(max_depth, spec)
    head = rec_h.shape[0]
    assert lims[0] == head, (lims, head)
    r = o.shape[0]
    rad = trace_replay(sd, o, d, pixel_ids, sample_ids, seed, head, rec_h)
    if len(lims) == 1:
        return rad
    r_n = rec_n.shape[1]
    depth_n = jnp.sum(((rec_n & F_ALIVE) > 0).astype(jnp.int32), axis=0)
    for j in range(1, len(lims)):
        dj, dv = lims[j], divs[j]
        lo_lim = lims[j - 1]
        in_b = valid_n & (depth_n > lo_lim) & (depth_n <= dj)
        n_b = jnp.sum(in_b.astype(jnp.int32))
        rank = jnp.cumsum(in_b.astype(jnp.int32)) - 1
        r_b = int(min(r_n, max(512, r // dv)))
        for p in range(passes):
            lo = p * r_b
            pos = rank - lo
            in_pass = in_b & (pos >= 0) & (pos < r_b)
            slot = jnp.where(in_pass, pos, r_b)
            idx_b = (
                jnp.zeros((r_b,), jnp.int32)
                .at[slot]
                .set(jnp.arange(r_n, dtype=jnp.int32), mode="drop")
            )
            lane_b = jnp.take(idx_n, idx_b, axis=0)
            valid_b = jnp.arange(r_b, dtype=jnp.int32) < n_b - lo
            thr0 = jnp.where(
                valid_b[:, None], jnp.ones((r_b, 3), jnp.float32), 0.0
            )
            pix_b = jnp.take(pixel_ids, lane_b, axis=0)
            smp_b = jnp.take(sample_ids, lane_b, axis=0)
            o_b, d_b, _ = generate_rays(cp, width, height, pix_b, smp_b, seed)
            rad_b = trace_replay(
                sd, o_b, d_b, pix_b, smp_b, seed, dj,
                jnp.take(rec_n[:dj], idx_b, axis=1),
                thr_in=thr0, accum_from=head,
            )
            rad = rad.at[lane_b].add(
                jnp.where(valid_b[:, None], rad_b, 0.0), mode="drop"
            )
        dropped = n_b - passes * r_b
        rad = jnp.where(dropped > 0, jnp.float32(jnp.nan), rad)
    # Narrow-record overflow: deep lanes beyond r_n never re-recorded.
    return jnp.where(n_deep > r_n, jnp.float32(jnp.nan), rad)


def render_rays_replay(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids,
    sample_ids,
    seed,
    max_depth: int,
    rec=None,
    split: bool | None = None,
    spec=None,
    record_div: int | None = None,
):
    """Primary rays + record + differentiable replay -> radiance (R, 3).

    The records are integer-valued (no tangents), so under ``jax.grad`` the
    record pass contributes nothing to the tape and the gradient is exactly
    the replay's detached-sampling estimator. The record pass is the staged
    lockstep :func:`trace_record`.

    ``rec``: optional PRECOMPUTED packed records for these exact
    (pixel, sample, seed) lanes — skips the record pass entirely. The
    frozen-decision training pattern (grad.record_decisions +
    grad.loss_and_grad): decisions depend only on geometry, material
    scalars and the camera, NOT on albedo/emission/texel values, so
    radiometric-parameter optimization can re-record every K steps and run
    replay-only gradient steps in between.

    ``split``: override the deep-budget lane-narrowing heuristic. None
    (default) narrows past ``GRAD_SPLIT_MIN_DEPTH``; ``False`` forces the
    unsplit differentiable replay — the escape hatch for enclosed /
    high-survivor scenes where the narrowed tail's fixed capacity would
    trip its NaN overflow guard (ADVICE r3); ``True`` forces narrowing.
    The ``CRUCIBLE_GRAD_SPLIT`` env var (0/1) overrides a ``None`` default.

    ``spec`` / ``record_div``: explicit bucket spec and narrow-record
    divisor overrides (win over the env knobs) — the capacity-widening
    rungs of grad.loss_and_grad_recovering's overflow-recovery ladder.
    """
    import os

    o, d, _ = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    # Shallow budgets replay unsplit: narrowing's compaction gathers cost
    # more than the few rows they save. Deep budgets (the 500-spp depth-50
    # north-star config) flip the trade: depth bucketing replaces 40+
    # full-width rows.
    if split is None:
        env = os.environ.get("CRUCIBLE_GRAD_SPLIT")
        if env is not None:
            split = env.lower() not in ("0", "off", "false")
        else:
            split = max_depth > GRAD_SPLIT_MIN_DEPTH
    use_2l = (
        split
        and rec is None
        and os.environ.get("CRUCIBLE_GRAD_DEEP_IMPL") != "split"
        and os.environ.get("CRUCIBLE_GRAD_2L", "1") not in ("0", "off", "false")
    )
    if use_2l:
        # Two-level record + bucketed replay: full-width head record plus a
        # narrow re-record of the deep survivors (see record_two_level).
        lims, _ = _bucket_spec(max_depth, spec)
        out = record_two_level(
            jax.lax.stop_gradient(sd),
            jax.lax.stop_gradient(cp),
            width, height, pixel_ids, sample_ids, seed, max_depth,
            head=lims[0], div=record_div,
        )
        return replay_bucketed_2l(
            sd, cp, width, height, o, d, pixel_ids, sample_ids, seed,
            max_depth, *out, spec=spec,
        )
    # The record pass produces only integers, but its interior (early-exit
    # while_loop) must not carry tangents at all — while_loop has no
    # linearization with unknown primals. Detach every float input.
    if rec is None:
        rec = trace_record(
            jax.lax.stop_gradient(sd),
            jax.lax.stop_gradient(o),
            jax.lax.stop_gradient(d),
            pixel_ids,
            sample_ids,
            seed,
            max_depth,
        )
    if not split:
        return trace_replay(sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec)
    if os.environ.get("CRUCIBLE_GRAD_DEEP_IMPL") == "split":
        # The r3 head/tail carry-handoff split, kept reachable for A/B
        # measurement — the bucketed replay replaced it.
        return replay_split(
            sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec,
            split_depth=GRAD_DEEP_SPLIT_DEPTH, long_div=GRAD_DEEP_LONG_DIV,
            early_exit=False,
        )
    # Precomputed records (frozen-decision training) arrive as one full
    # (D, R) buffer — bucket over it directly.
    return replay_bucketed(
        sd, cp, width, height, o, d, pixel_ids, sample_ids, seed,
        max_depth, rec, spec=spec,
    )
