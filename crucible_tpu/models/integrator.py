"""Wavefront path integrator: the batched re-imagination of ``ray_color``.

The reference integrates recursively per ray (src/camera/ray_casting.rs:
112-152): on hit, ``attenuation * ray_color(scattered, depth-1)``; on miss,
skybox radiance; at depth 0, black. Unrolling the recursion into an
iterative product gives the mathematically identical wavefront form used
here over a flat batch of R rays:

    L      += throughput * sky        (on miss)
    L      += throughput * emission   (on hit — extension, zero by default)
    throughput *= attenuation         (on scatter)
    black at depth exhaustion         (rays alive after max_depth add 0)

The bounce loop is a ``lax.while_loop`` that exits early once every ray in
the wavefront is dead — dynamic trip count, static shapes, no recursion.

Gradient stance (SURVEY.md §7 "Differentiability"): discrete decisions
(hit/miss masks, argmin winners, material branches, RNG) are inherently
non-differentiable and act as detached samples; continuous quantities
(hit t, normals, attenuations, sky radiance, emission) stay on the autodiff
tape, giving detached-sampling interior gradients w.r.t. material albedo,
texels, emission, skybox images, and camera parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from crucible_tpu.models import materials as mat_mod
from crucible_tpu.models import skybox as sky_mod
from crucible_tpu.models import textures as tex_mod
from crucible_tpu.models.camera import CameraParams, generate_rays
from crucible_tpu.models.scene import SceneData
from crucible_tpu.ops import intersect
from crucible_tpu.ops.traverse import bvh_hit_triangles
from crucible_tpu.utils import rng as crng
from crucible_tpu.utils import vec

T_MIN = 1.0e-3  # shadow-acne epsilon (src/camera/ray_casting.rs:119)
BIG = intersect.BIG


def exact_tri_vertices(sd: SceneData, pid, t_ray):
    """Per-candidate exact-motion triangle vertices -> (a, b, c), each (R, 3).

    Gathers the three vertex-major timeline track rows of triangle ``pid``
    (leaf order for BVH meshes) and evaluates position = scale(t) *
    translate(t) * origin at each ray's absolute time (the vectorized
    counterpart of src/objects/triangle.rs:91-97 evaluating per-vertex
    timelines at ray.time()). O(R * K) — candidates only, never (R, M)."""
    from crucible_tpu.models import timeline as tl_mod

    m_rows = sd.tri_v0.shape[0]
    out = []
    for vi in range(3):
        rows = pid + vi * m_rows
        pos = tl_mod.eval_translate_rows(
            jnp.take(sd.tri_tr_t0, rows, axis=0),
            jnp.take(sd.tri_tr_t1, rows, axis=0),
            jnp.take(sd.tri_tr_delta, rows, axis=0),
            jnp.take(sd.tri_tr_init, rows, axis=0),
            t_ray,
        )
        scl = tl_mod.eval_scale_rows(
            jnp.take(sd.tri_sc_t0, rows, axis=0),
            jnp.take(sd.tri_sc_t1, rows, axis=0),
            jnp.take(sd.tri_sc_from, rows, axis=0),
            jnp.take(sd.tri_sc_to, rows, axis=0),
            t_ray,
        )
        out.append(scl * pos)
    return tuple(out)


def exact_sphere_winner(sd: SceneData, i_s, t_ray):
    """Per-winner exact-motion sphere (center, radius) at each ray's time —
    the replay/record counterpart of the exact branch's full (R, N)
    evaluation (src/objects/sphere.rs:67-69). O(R * K)."""
    from crucible_tpu.models import timeline as tl_mod

    c_w = tl_mod.eval_translate_rows(
        jnp.take(sd.sph_tr_t0, i_s, axis=0),
        jnp.take(sd.sph_tr_t1, i_s, axis=0),
        jnp.take(sd.sph_tr_delta, i_s, axis=0),
        jnp.take(sd.sph_tr_init, i_s, axis=0),
        t_ray,
    )
    r_w = tl_mod.eval_scale_rows(
        jnp.take(sd.sph_sc_t0, i_s, axis=0),
        jnp.take(sd.sph_sc_t1, i_s, axis=0),
        jnp.take(sd.sph_sc_from, i_s, axis=0),
        jnp.take(sd.sph_sc_to, i_s, axis=0),
        t_ray,
    )[..., 0]
    return c_w, r_w


def intersect_scene(sd: SceneData, o, d, w=None):
    """Closest hit against all scene primitives.

    Returns a dict of per-ray arrays:
      hit (bool), t, point (R,3), normal (R,3) front-face-flipped unit,
      front (bool), u, v, mat (int32).
    """
    r = o.shape[0]
    animated = sd.animated
    exact = animated and sd.motion_exact
    if exact:
        # Exact per-ray-time evaluation (keyframe inside the shutter window;
        # models/scene.py build detection). Evaluates the piecewise-linear
        # tracks at the ray's absolute time — the vectorized counterpart of
        # the reference re-evaluating the whole timeline per ray
        # (src/objects/sphere.rs:67-69). O(R*N*K) — a correctness path, not
        # a fast path (the linear-shutter model covers everything else).
        from crucible_tpu.models import timeline as tl_mod

        assert w is not None
        t_ray = sd.motion_t0 + w * (sd.motion_t1 - sd.motion_t0)
        centers_rt = tl_mod.eval_translate(
            sd.sph_tr_t0, sd.sph_tr_t1, sd.sph_tr_delta, sd.sph_tr_init, t_ray
        )  # (R, N, 3)
        radii_rt = tl_mod.eval_scale(
            sd.sph_sc_t0, sd.sph_sc_t1, sd.sph_sc_from, sd.sph_sc_to, t_ray
        )[..., 0]  # (R, N)
        t_s, i_s, hit_s = intersect.hit_spheres(
            o, d, centers_rt, radii_rt, sd.sph_active, T_MIN, jnp.inf
        )
    elif animated:
        assert w is not None, "animated scenes need per-ray shutter fractions"
        t_s, i_s, hit_s = intersect.hit_spheres_moving(
            o,
            d,
            w,
            sd.sph_center,
            sd.sph_center_d,
            sd.sph_radius,
            sd.sph_radius_d,
            sd.sph_active,
            T_MIN,
            jnp.inf,
        )
    else:
        t_s, i_s, hit_s = intersect.hit_spheres(
            o, d, sd.sph_center, sd.sph_radius, sd.sph_active, T_MIN, jnp.inf
        )

    moving_tris = animated and sd.tri_v0_d is not None and not sd.tri_exact
    tri_rt = None
    exact_winner_fn = None
    if sd.num_tris > 0 and exact and sd.tri_exact:
        from crucible_tpu.models import timeline as tl_mod

        if sd.use_bvh:
            # Per-candidate vertex timelines evaluated at the ray's time
            # inside the leaf test — the reference's per-ray traversal-time
            # evaluation (src/objects/bvhwrapper.rs:102-106) without the
            # per-ray AABB mutation (node bounds enclose the full
            # trajectory; models/scene.py unions over keyframe kinks).
            exact_winner_fn = lambda pid: exact_tri_vertices(sd, pid, t_ray)
            t_t, i_t, hit_t = bvh_hit_triangles(
                o,
                d,
                sd.tri_v0,
                sd.tri_v1,
                sd.tri_v2,
                sd.bvh_min,
                sd.bvh_max,
                sd.bvh_first,
                sd.bvh_count,
                sd.bvh_miss,
                T_MIN,
                BIG,
                sd.bvh_leaf_size,
                vertex_fn=exact_winner_fn,
            )
        else:
            vall = tl_mod.eval_translate(
                sd.tri_tr_t0, sd.tri_tr_t1, sd.tri_tr_delta, sd.tri_tr_init,
                t_ray,
            )  # (R, 3M, 3) vertex-major
            sall = tl_mod.eval_scale(
                sd.tri_sc_t0, sd.tri_sc_t1, sd.tri_sc_from, sd.tri_sc_to, t_ray
            )
            vall = sall * vall  # reference: scale(t) * translate(t) * origin
            m_rows = sd.tri_v0.shape[0]
            tri_rt = (
                vall[:, 0:m_rows],
                vall[:, m_rows : 2 * m_rows],
                vall[:, 2 * m_rows : 3 * m_rows],
            )
            t_t, i_t, hit_t = intersect.hit_triangles(
                o, d, tri_rt[0], tri_rt[1], tri_rt[2], sd.tri_active, T_MIN, jnp.inf
            )
        is_tri = hit_t & (t_t < t_s)
    elif sd.num_tris > 0:
        motion = (
            dict(v0d=sd.tri_v0_d, v1d=sd.tri_v1_d, v2d=sd.tri_v2_d, w=w)
            if moving_tris
            else {}
        )
        if sd.use_bvh:
            t_t, i_t, hit_t = bvh_hit_triangles(
                o,
                d,
                sd.tri_v0,
                sd.tri_v1,
                sd.tri_v2,
                sd.bvh_min,
                sd.bvh_max,
                sd.bvh_first,
                sd.bvh_count,
                sd.bvh_miss,
                T_MIN,
                BIG,
                sd.bvh_leaf_size,
                **motion,
            )
        else:
            t_t, i_t, hit_t = intersect.hit_triangles(
                o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_active, T_MIN, jnp.inf,
                **motion,
            )
        is_tri = hit_t & (t_t < t_s)
    else:
        t_t = jnp.full((r,), BIG)
        i_t = jnp.zeros((r,), jnp.int32)
        is_tri = jnp.zeros((r,), bool)

    hit = hit_s | is_tri
    t = jnp.where(is_tri, t_t, t_s)
    # Miss lanes carry t = BIG; clamp the shading-point t to keep all
    # downstream geometry finite (inf would turn masked-out lanes into NaN
    # gradients via 0 * inf in the backward pass).
    t_shade = jnp.where(hit, t, 1.0)
    point = o + t_shade[:, None] * d

    # Sphere shading attributes (src/objects/sphere.rs:95-105).
    if exact:
        c_w = jnp.take_along_axis(centers_rt, i_s[:, None, None], axis=1)[:, 0]
        r_w = jnp.take_along_axis(radii_rt, i_s[:, None], axis=1)[:, 0]
    else:
        c_w = jnp.take(sd.sph_center, i_s, axis=0)
        r_w = jnp.take(sd.sph_radius, i_s, axis=0)
        if animated:
            c_w = c_w + w[:, None] * jnp.take(sd.sph_center_d, i_s, axis=0)
            r_w = r_w + w * jnp.take(sd.sph_radius_d, i_s, axis=0)
    n_sph = (point - c_w) / jnp.maximum(r_w, 1e-20)[:, None]
    u_sph, v_sph = intersect.sphere_uv(n_sph)

    if sd.num_tris > 0:
        if exact_winner_fn is not None:
            a, b, c = exact_winner_fn(i_t)
        elif tri_rt is not None:
            sel = i_t[:, None, None]
            a = jnp.take_along_axis(tri_rt[0], sel, axis=1)[:, 0]
            b = jnp.take_along_axis(tri_rt[1], sel, axis=1)[:, 0]
            c = jnp.take_along_axis(tri_rt[2], sel, axis=1)[:, 0]
        else:
            a = jnp.take(sd.tri_v0, i_t, axis=0)
            b = jnp.take(sd.tri_v1, i_t, axis=0)
            c = jnp.take(sd.tri_v2, i_t, axis=0)
        if moving_tris:
            a = a + w[:, None] * jnp.take(sd.tri_v0_d, i_t, axis=0)
            b = b + w[:, None] * jnp.take(sd.tri_v1_d, i_t, axis=0)
            c = c + w[:, None] * jnp.take(sd.tri_v2_d, i_t, axis=0)
        n_tri = intersect.triangle_normal(a, b, c)
        n_out = jnp.where(is_tri[:, None], n_tri, n_sph)
        mat = jnp.where(
            is_tri, jnp.take(sd.tri_mat, i_t, axis=0), jnp.take(sd.sph_mat, i_s, axis=0)
        )
        # Triangle uv hardcoded (0,0) in the reference (triangle.rs:133-134).
        uu = jnp.where(is_tri, 0.0, u_sph)
        vv = jnp.where(is_tri, 0.0, v_sph)
    else:
        n_out = n_sph
        mat = jnp.take(sd.sph_mat, i_s, axis=0)
        uu, vv = u_sph, v_sph

    front = vec.dot(d, n_out) < 0.0
    normal = jnp.where(front[:, None], n_out, -n_out)
    return dict(
        hit=hit, t=t, point=point, normal=normal, front=front, u=uu, v=vv,
        mat=mat, i_sph=i_s, i_tri=i_t, is_tri=is_tri,
    )


def bounce_step(
    sd: SceneData, o, d, pixel_ids, sample_ids, bounce, seed,
    return_decisions=False,
):
    """One wavefront bounce: intersect, shade, sample the next direction.

    ``bounce`` may be a scalar (lockstep loop) or a per-ray (R,) array
    (persistent wavefront — each lane is at its own depth).

    Returns a dict:
      contrib (R, 3): radiance contribution BEFORE throughput weighting
        (sky on miss + emission on hit)
      hit (R,) bool, scattered (R,) bool
      new_o, new_d (R, 3), atten (R, 3)
    """
    if sd.animated:
        # Per-ray shutter fraction — same hash as the camera's time sample,
        # so scattered rays inherit the primary ray's time (reference:
        # Ray::new_at_time(.., r_in.time()), materials/*.rs).
        w = crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)
    else:
        w = None
    h = intersect_scene(sd, o, d, w=w)
    hit = h["hit"]

    sky = sky_mod.radiance(sd.sky_kind, sd.sky_image, d)
    mat = h["mat"]
    emission = jnp.take(sd.mat_emission, mat, axis=0)
    contrib = jnp.where(hit[:, None], emission, sky)

    albedo = tex_mod.value(
        sd.tex, jnp.take(sd.mat_tex, mat, axis=0), h["u"], h["v"], h["point"]
    )
    u_dir1, u_dir2, u_decide = crng.uniform3(
        pixel_ids,
        sample_ids,
        jnp.uint32(crng.STREAM_BOUNCE_BASE) + jnp.asarray(bounce).astype(jnp.uint32),
        seed,
    )
    scat_out = mat_mod.scatter(
        jnp.take(sd.mat_type, mat, axis=0),
        jnp.take(sd.mat_fuzz, mat, axis=0),
        jnp.take(sd.mat_ior, mat, axis=0),
        jnp.take(sd.mat_prob, mat, axis=0),
        albedo,
        d,
        h["normal"],
        h["front"],
        u_dir1,
        u_dir2,
        u_decide,
        return_decisions=return_decisions,
    )
    out = dict(
        contrib=contrib,
        hit=hit,
        scattered=scat_out[2],
        new_o=h["point"],
        new_d=scat_out[0],
        atten=scat_out[1],
    )
    if return_decisions:
        out.update(
            decisions=scat_out[3],
            front=h["front"],
            i_sph=h["i_sph"],
            i_tri=h["i_tri"],
            is_tri=h["is_tri"],
        )
    return out


def make_sphere_table(sd: SceneData):
    """Per-sphere attribute table (N, 31): the winner-row fetch of the
    replay (models/replay.py). Built from the differentiable scene tables
    with N-sized (tiny) gathers; loop-invariant per render.

    Columns: 0-2 center, 3 radius, 4 |c|^2 - r^2, 5 active, 6 material
    type, 7 fuzz, 8 ior, 9 scatter probability, 10-12 emission, 13 texture
    kind, 14-16 solid color, 17 checker 1/scale, 18-20 / 21-23 even / odd
    checker colors, 24-26 center motion delta, 27 radius delta, 28-29
    motion quadratic terms, 30 texture id. Motion columns are zeros for
    static scenes."""
    mat = sd.sph_mat
    tid = jnp.take(sd.mat_tex, mat, axis=0)
    even_id = jnp.take(sd.tex.even, tid, axis=0)
    odd_id = jnp.take(sd.tex.odd, tid, axis=0)
    if sd.animated and sd.sph_center_d is not None:
        cd = sd.sph_center_d
        rd = sd.sph_radius_d
    else:
        cd = jnp.zeros_like(sd.sph_center)
        rd = jnp.zeros_like(sd.sph_radius)
    cols = [
        sd.sph_center[:, 0],
        sd.sph_center[:, 1],
        sd.sph_center[:, 2],
        sd.sph_radius,
        jnp.sum(sd.sph_center * sd.sph_center, -1) - sd.sph_radius * sd.sph_radius,
        sd.sph_active.astype(jnp.float32),
        jnp.take(sd.mat_type, mat, axis=0).astype(jnp.float32),
        jnp.take(sd.mat_fuzz, mat, axis=0),
        jnp.take(sd.mat_ior, mat, axis=0),
        jnp.take(sd.mat_prob, mat, axis=0),
        jnp.take(sd.mat_emission, mat, axis=0)[:, 0],
        jnp.take(sd.mat_emission, mat, axis=0)[:, 1],
        jnp.take(sd.mat_emission, mat, axis=0)[:, 2],
        jnp.take(sd.tex.kind, tid, axis=0).astype(jnp.float32),
        jnp.take(sd.tex.color, tid, axis=0)[:, 0],
        jnp.take(sd.tex.color, tid, axis=0)[:, 1],
        jnp.take(sd.tex.color, tid, axis=0)[:, 2],
        jnp.take(sd.tex.inv_scale, tid, axis=0),
        jnp.take(sd.tex.color, even_id, axis=0)[:, 0],
        jnp.take(sd.tex.color, even_id, axis=0)[:, 1],
        jnp.take(sd.tex.color, even_id, axis=0)[:, 2],
        jnp.take(sd.tex.color, odd_id, axis=0)[:, 0],
        jnp.take(sd.tex.color, odd_id, axis=0)[:, 1],
        jnp.take(sd.tex.color, odd_id, axis=0)[:, 2],
        cd[:, 0],
        cd[:, 1],
        cd[:, 2],
        rd,
        jnp.sum(sd.sph_center * cd, -1) - sd.sph_radius * rd,  # s1
        jnp.sum(cd * cd, -1) - rd * rd,  # s2
        tid.astype(jnp.float32),  # 30: texture id (replay image lookups)
    ]
    return jnp.stack(cols, axis=1)


def trace(
    sd: SceneData,
    o,
    d,
    pixel_ids,
    sample_ids,
    seed,
    max_depth: int,
    differentiable: bool = False,
):
    """Integrate radiance for a wavefront of primary rays -> (R, 3).

    Lockstep bounce loop — the direct unrolling of the reference recursion.
    ``differentiable=False`` uses a while_loop with early exit once every
    ray died (fast forward-only path); ``differentiable=True`` uses a
    static-trip-count scan so reverse-mode autodiff works (while_loop has
    no transpose rule). Identical results either way.
    """
    r = o.shape[0]
    throughput0 = jnp.ones((r, 3), jnp.float32)
    radiance0 = jnp.zeros((r, 3), jnp.float32)
    alive0 = jnp.ones((r,), bool)
    bounce0 = jnp.int32(0)

    def body(state):
        bounce, o_c, d_c, throughput, radiance, alive = state
        s = bounce_step(sd, o_c, d_c, pixel_ids, sample_ids, bounce, seed)
        radiance = radiance + jnp.where(
            alive[:, None], throughput * s["contrib"], 0.0
        )
        new_alive = alive & s["hit"] & s["scattered"]
        throughput = jnp.where(new_alive[:, None], throughput * s["atten"], throughput)
        o_c = jnp.where(new_alive[:, None], s["new_o"], o_c)
        d_c = jnp.where(new_alive[:, None], s["new_d"], d_c)
        return bounce + 1, o_c, d_c, throughput, radiance, new_alive

    state = (bounce0, o, d, throughput0, radiance0, alive0)
    if differentiable:
        # Rematerialize each bounce in the backward pass: without this the
        # AD tape holds every (R, N) intersection intermediate for all
        # max_depth bounces (O(depth * R * N) memory); with it, backward
        # memory is one bounce deep at the cost of recomputing forwards
        # (the usual jax.checkpoint memory-for-compute trade).
        @jax.checkpoint
        def scan_body(state, _):
            return body(state), None

        state, _ = jax.lax.scan(scan_body, state, None, length=max_depth)
    else:
        def cond(state):
            bounce, _, _, _, _, alive = state
            return (bounce < max_depth) & jnp.any(alive)

        state = jax.lax.while_loop(cond, body, state)
    return state[4]


def trace_persistent(
    sd: SceneData,
    cp,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    lanes: int = 0,
    return_stats: bool = False,
    sample_start=0,
    pixel_ids=None,
):
    """Persistent-wavefront path tracer with lane-local sample regeneration.

    The wavefront answer to ray compaction (SURVEY.md §7 "Wavefront integrator"):
    every vector lane is PERMANENTLY bound to one pixel and walks that
    pixel's spp samples sequentially. When a lane's path dies (sky hit,
    absorption, depth exhausted) it immediately starts the pixel's next
    sample — no global work queue, no prefix sums, and NO scatter-adds
    into a framebuffer: each lane
    accumulates privately and the framebuffer is just the accumulator array.

    Lane utilization is governed by path-length variance *summed over spp
    samples*, which concentrates sharply (CLT), so busy work stays ~100%
    except in the final tail. Because every random number is a pure hash of
    (pixel, sample, bounce) (utils/rng.py), the image is identical to
    :func:`trace` over the same sample set, up to f32 summation order.

    ``lanes`` is a TARGET lane count: the pixel grid is replicated into
    G = ceil(lanes / pixels) SAMPLE GROUPS (clamped to spp) — lane (g, p)
    traces pixel p's samples g, g+G, g+2G, ... This saturates the chip on
    small images AND shortens the serial tail (each lane sums ~spp/G path
    lengths, so the max-over-lanes concentrates). Group accumulators reduce
    with one reshape-sum at the end — still no scatter.

    Returns the per-pixel radiance SUM (num_pixels, 3); divide by spp.

    ``spp`` may be a Python int (static) or a traced uint32 scalar — traced
    spp keeps ONE compiled executable across sample counts (the group count
    then comes from ``lanes`` alone; groups beyond spp idle, which only
    wastes lanes when spp is tiny).

    ``sample_start`` renders samples [sample_start, spp) — the chunked
    progress-reporting driver (models/render.py) sums chunk renders, same
    sample set as one call up to f32 summation order.

    ``pixel_ids`` (P,) renders only those pixels of the frame (sums (P, 3));
    ``lanes`` then counts lanes for those P pixels.
    """
    num_pixels = width * height if pixel_ids is None else pixel_ids.shape[0]
    spp_static = int(spp) if isinstance(spp, (int, np.integer)) else None
    groups = max(1, (max(lanes, 1) + num_pixels - 1) // num_pixels)
    if spp_static is not None:
        groups = min(spp_static, groups)
    spp = jnp.asarray(spp, jnp.uint32)
    sample_start = jnp.asarray(sample_start, jnp.uint32)
    r = groups * num_pixels

    lane = jnp.arange(r, dtype=jnp.uint32)
    pix = lane % num_pixels
    if pixel_ids is not None:
        pix = jnp.take(pixel_ids, pix)
    grp = lane // num_pixels

    acc0 = jnp.zeros((r, 3), jnp.float32)
    sample0 = (sample_start + grp).astype(jnp.uint32)
    alive0 = jnp.zeros((r,), bool)
    bounce0 = jnp.zeros((r,), jnp.int32)
    o0 = jnp.zeros((r, 3), jnp.float32)
    d0 = jnp.ones((r, 3), jnp.float32)
    thr0 = jnp.zeros((r, 3), jnp.float32)

    def cond(state):
        sample_i, alive, *_ = state[:-1] if return_stats else state
        return jnp.any(alive | (sample_i < spp))

    def body(state):
        if return_stats:
            *state, iters = state
        sample_i, alive, bounce, o, d, thr, acc = state

        # --- lane-local regeneration: this lane's next sample -------------
        issue = (~alive) & (sample_i < spp)
        no, nd, _ = generate_rays(cp, width, height, pix, sample_i, seed)
        o = jnp.where(issue[:, None], no, o)
        d = jnp.where(issue[:, None], nd, d)
        thr = jnp.where(issue[:, None], 1.0, thr)
        bounce = jnp.where(issue, 0, bounce)
        alive = alive | issue

        # The sample id that rays in flight belong to (issued now or earlier).
        smp = jnp.where(alive & ~issue, sample_i - groups, sample_i)
        smp_next = jnp.where(issue, sample_i + groups, sample_i)

        # --- one bounce for every lane ------------------------------------
        s = bounce_step(sd, o, d, pix, smp, bounce, seed)
        acc = acc + jnp.where(alive[:, None], thr * s["contrib"], 0.0)

        cont = alive & s["hit"] & s["scattered"] & (bounce + 1 < max_depth)
        thr = jnp.where(cont[:, None], thr * s["atten"], thr)
        o = jnp.where(cont[:, None], s["new_o"], o)
        d = jnp.where(cont[:, None], s["new_d"], d)
        bounce = bounce + 1
        out = (smp_next, cont, bounce, o, d, thr, acc)
        return out + (iters + 1,) if return_stats else out

    state = (sample0, alive0, bounce0, o0, d0, thr0, acc0)
    if return_stats:
        *rest, acc, iters = jax.lax.while_loop(
            cond, body, state + (jnp.int32(0),)
        )
        return acc.reshape(groups, num_pixels, 3).sum(axis=0), iters
    *_, acc = jax.lax.while_loop(cond, body, state)
    return acc.reshape(groups, num_pixels, 3).sum(axis=0)


def make_mat_table(sd: SceneData):
    """Per-material attribute table (L, 19) for the replay's triangle-hit
    fetch (models/replay.py). Columns match :func:`make_sphere_table`'s
    columns 6-24 shifted down by 6: 0 material type, 1 fuzz, 2 ior, 3
    scatter probability, 4-6 emission, 7 texture kind, 8-10 solid color,
    11 checker 1/scale, 12-14 / 15-17 even / odd checker colors, 18 texture
    id."""
    tid = sd.mat_tex
    even_id = jnp.take(sd.tex.even, tid, axis=0)
    odd_id = jnp.take(sd.tex.odd, tid, axis=0)
    return jnp.concatenate(
        [
            sd.mat_type.astype(jnp.float32)[:, None],
            sd.mat_fuzz[:, None],
            sd.mat_ior[:, None],
            sd.mat_prob[:, None],
            sd.mat_emission,
            jnp.take(sd.tex.kind, tid, axis=0).astype(jnp.float32)[:, None],
            jnp.take(sd.tex.color, tid, axis=0),
            jnp.take(sd.tex.inv_scale, tid, axis=0)[:, None],
            jnp.take(sd.tex.color, even_id, axis=0),
            jnp.take(sd.tex.color, odd_id, axis=0),
            tid.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def trace_persistent_queue(
    sd: SceneData,
    cp,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    lanes: int,
    return_stats: bool = False,
    sample_start=0,
):
    """Persistent wavefront with a STRIDED GLOBAL path schedule.

    Lane i processes path ids i, i+R, i+2R, ... where path q maps to
    (pixel = q mod P, sample = q div P). Because consecutive paths of one
    lane orbit through many different pixels, per-lane total work
    concentrates by CLT even when path length is strongly pixel-dependent
    (glass-heavy pixels) — the failure mode of the lane-per-pixel schedule,
    whose worst lane must grind all spp samples of the worst pixel. The
    price is a scatter-add into the framebuffer each iteration (the
    lane-per-pixel schedule is scatter-free). Static schedule, no global
    counter, no prefix sums.

    Same RNG per (pixel, sample) => same image as the other modes up to
    f32 summation order.

    Returns the per-pixel radiance SUM (num_pixels, 3).

    ``spp`` may be a Python int or a traced uint32 scalar (single compile
    across sample counts). Total path count (pixels * spp) must stay below
    2^31 — int32 path ids (int64 needs jax x64 mode).
    """
    num_pixels = width * height
    r = max(512, ((lanes + 511) // 512) * 512)
    if isinstance(spp, (int, np.integer)):
        total_static = num_pixels * int(spp)
        assert total_static < 2**31, "queue schedule path ids overflow int32"
        r = min(r, ((total_static + 511) // 512) * 512)
    total = jnp.int32(num_pixels) * jnp.asarray(spp, jnp.int32)

    lane = jnp.arange(r, dtype=jnp.int32)
    # "previous" path id; first issue advances by r into [start, total).
    q0 = lane - r + jnp.asarray(sample_start, jnp.int32) * num_pixels
    fb0 = jnp.zeros((num_pixels, 3), jnp.float32)

    state0 = (
        q0,
        jnp.zeros((r,), bool),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r, 3), jnp.float32),
        jnp.ones((r, 3), jnp.float32),
        jnp.zeros((r, 3), jnp.float32),
        fb0,
    )

    def cond(state):
        q, alive, *_ = state[:-1] if return_stats else state
        return jnp.any(alive | (q + r < total))

    def body(state):
        if return_stats:
            *state, iters = state
        q, alive, bounce, o, d, thr, fb = state

        issue = (~alive) & (q + r < total)
        q = jnp.where(issue, q + r, q)
        active = alive | issue
        pix = (jnp.where(q >= 0, q, 0) % num_pixels).astype(jnp.uint32)
        smp = (jnp.where(q >= 0, q, 0) // num_pixels).astype(jnp.uint32)

        no, nd, _ = generate_rays(cp, width, height, pix, smp, seed)
        o = jnp.where(issue[:, None], no, o)
        d = jnp.where(issue[:, None], nd, d)
        thr = jnp.where(issue[:, None], 1.0, thr)
        bounce = jnp.where(issue, 0, bounce)

        s = bounce_step(sd, o, d, pix, smp, bounce, seed)
        contrib = jnp.where(active[:, None], thr * s["contrib"], 0.0)
        fb = fb.at[pix].add(contrib)

        cont = active & s["hit"] & s["scattered"] & (bounce + 1 < max_depth)
        thr = jnp.where(cont[:, None], thr * s["atten"], thr)
        o = jnp.where(cont[:, None], s["new_o"], o)
        d = jnp.where(cont[:, None], s["new_d"], d)
        out = (q, cont, bounce + 1, o, d, thr, fb)
        return out + (iters + 1,) if return_stats else out

    if return_stats:
        *rest, fb, iters = jax.lax.while_loop(cond, body, state0 + (jnp.int32(0),))
        return fb, iters
    *_, fb = jax.lax.while_loop(cond, body, state0)
    return fb


def render_rays(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids,
    sample_ids,
    seed,
    max_depth: int,
    differentiable: bool = False,
):
    """Primary-ray generation + path tracing for (pixel, sample) pairs."""
    o, d, _times = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    return trace(
        sd, o, d, pixel_ids, sample_ids, seed, max_depth,
        differentiable=differentiable,
    )
