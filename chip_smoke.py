"""Drive the path tracer's main paths once on one GPU and check them.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases, all in this one process and through the normal entry points:

- ``forward``: the CLI renders book1 at 1920 wide, 32 spp, depth 50.
- ``forward_vs_cpu``: 4,096 pixel ids of the 1920x1080 frame rendered
  through the platform route, against the lockstep ``integrator.render_rays``
  on the CPU device.
- ``closest_hit``: the fused closest-hit against the float64 reference
  (``closest_hit64``) at 488 and 7,744 sphere rows.
- ``train``: ``grad.make_train_step`` (optax) takes 3 steps at 1920x1080 x 4
  spp, depth 8, then one frozen-decision step (``grad.record_decisions`` +
  ``loss_and_grad(rec=...)``).
- ``grad_vs_cpu``: the record pass and ``loss_and_grad`` over 65,536 pixels
  of that batch on the card and on the CPU device, compared lane by lane
  and leaf by leaf against the CPU's own rounding sensitivity
  (``_compare_grads``).
- ``movie``: two frames of ``demo.first_movie`` through ``render_movie``.

Every phase prints its compile and wall seconds; no phase catches its own
failure. The last line of stdout is one JSON object naming the device.
With no GPU the script raises before any phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from crucible_tpu import grad as grad_mod
from crucible_tpu.models import demo, integrator, render
from crucible_tpu.models.camera import generate_rays
from crucible_tpu.ops import intersect
from crucible_tpu.utils import backend

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_compile_seconds = [0.0]


def _on_event(event, duration, **_):
    if event == _COMPILE_EVENT:
        _compile_seconds[0] += duration


jax.monitoring.register_event_duration_secs_listener(_on_event)


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's compile seconds (XLA's backend compile, summed from
    JAX's own monitoring events) and wall seconds."""
    c0, t0 = _compile_seconds[0], time.perf_counter()
    yield
    print(
        f"phase {name}: compile {_compile_seconds[0] - c0:.3f} s, "
        f"wall {time.perf_counter() - t0:.3f} s",
        flush=True,
    )


def cpu_device():
    return jax.devices("cpu")[0]


def card_name_and_power() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _scene(make, width, **kw):
    sc = make(width=width, **kw)
    return sc, sc.build(), sc.scene_cam.params()


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def forward_cli(out_dir: Path, width: int = 1920, spp: int = 32) -> dict:
    """Render book1 through the CLI at the scene's depth (50) and read the
    image back."""
    from crucible_tpu import cli
    from crucible_tpu.io.image import read_ppm

    path = out_dir / "book1.ppm"
    rc = cli.main(
        ["--file", str(path), "--world", "1", "--width", str(width),
         "--spp", str(spp)]
    )
    assert rc == 0, rc
    img = read_ppm(path)
    h = int(width * 9 / 16)
    assert img.shape == (h, width, 3), img.shape
    assert img.std() > 10, "image has no structure"
    return dict(shape=img.shape, mean=float(img.mean()))


def forward_vs_cpu(
    width: int = 1920, spp: int = 4, depth: int = 50, n_pixels: int = 4096,
    seed: int = 0,
) -> dict:
    """Pixel ids of the full frame through the platform route, against the
    lockstep ``render_rays`` on the CPU device with the same pixel ids,
    samples and seed. Decisions and RNG are identical; only f32 contraction
    differs, which flips the odd silhouette sample — hence the bounds of
    tests/test_golden.py: under 3% of values off by more than 1e-3, mean
    absolute difference under 3e-3."""
    sc, sd, cp = _scene(demo.book1_end_scene, width)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    img = render.render_image_data(sd, cp, w, h, spp, depth, seed)
    pix = np.sort(
        np.random.default_rng(seed).choice(w * h, n_pixels, replace=False)
    ).astype(np.uint32)
    got = img.reshape(-1, 3)[pix]

    cpu = cpu_device()
    sd_c, cp_c = jax.device_put((sd, cp), cpu)
    pix_r = jax.device_put(np.tile(pix, spp), cpu)
    smp_r = jax.device_put(np.repeat(np.arange(spp, dtype=np.uint32), n_pixels), cpu)

    @jax.jit
    def ref_fn(sd_, cp_, p_, s_):
        rad = integrator.render_rays(sd_, cp_, w, h, p_, s_, jnp.uint32(seed), depth)
        return rad.reshape(spp, n_pixels, 3).mean(axis=0)

    want = np.asarray(ref_fn(sd_c, cp_c, pix_r, smp_r))
    diff = np.abs(got - want)
    out = dict(
        frac_over_1e3=float((diff > 1e-3).mean()),
        mean_abs=float(diff.mean()),
        max_abs=float(diff.max()),
    )
    assert np.isfinite(got).all()
    assert out["frac_over_1e3"] < 0.03, out
    assert out["mean_abs"] < 3e-3, out
    return out


# --------------------------------------------------------------------------
# Closest hit
# --------------------------------------------------------------------------


def hit_rays(sd, cp, width, height, n_rays, seed=0):
    """Half primary rays of random pixels, half secondary rays leaving the
    primary hit points in random directions (these start on a surface, so
    they exercise the t_min edge)."""
    rng = np.random.default_rng(seed)
    n = n_rays // 2
    pix = jnp.asarray(rng.integers(0, width * height, n), jnp.uint32)
    o, d, _ = generate_rays(
        cp, width, height, pix, jnp.zeros_like(pix), jnp.uint32(seed)
    )
    t, _, hit = intersect.hit_spheres(
        o, d, sd.sph_center, sd.sph_radius, sd.sph_active,
        integrator.T_MIN, jnp.inf,
    )
    p = o + jnp.where(hit, t, 1.0)[:, None] * d
    d2 = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return jnp.concatenate([o, p]), jnp.concatenate([d, d2])


_U32 = float(np.finfo(np.float32).eps) / 2  # f32 unit roundoff


def _pair64(o, d, c, r):
    """Per row: the reference's quadratic (src/objects/sphere.rs), in the
    geometric form of ``intersect._roots``, of ray (o, d) against sphere
    (c, r) in float64 -> (near root, far root, q,
    err_q, err_t). ``q = r^2 - l^2`` decides the hit as in ``intersect``;
    ``err_q`` and ``err_t`` bound what evaluating it in f32 can move q and
    a root: rounding ``oc = c - o`` and the products costs a few units of
    roundoff of |oc|, of l |oc| and of r^2."""
    oc = c - o
    a = np.sum(d * d, -1)
    nd, noc = np.sqrt(a), np.linalg.norm(oc, axis=-1)
    tc = np.sum(d * oc, -1) / a
    l2 = np.sum((oc - tc[..., None] * d) ** 2, -1)
    q = r * r - l2
    s = np.sqrt(np.maximum(q, 0.0) / a)
    err_q = _U32 * (14 * np.sqrt(l2) * noc + 3 * (r * r + l2))
    err_s = err_q / (2 * np.sqrt(np.maximum(np.abs(q), err_q) * a)) + _U32 * s
    err_t = 4 * _U32 * noc / nd + _U32 * np.abs(tc) + err_s
    return tc - s, tc + s, q, err_q, err_t + _U32 * (np.abs(tc) + s)


def closest_hit64(o, d, centers, radii, active, t_min, chunk=256):
    """The plain reference: every (ray, sphere) pair in float64 on the host,
    the near root preferred, the first of equal roots winning -> (t, idx,
    hit), t = inf where nothing is hit."""
    o, d, c, r = (np.asarray(x, np.float64) for x in (o, d, centers, radii))
    act = np.asarray(active, bool)
    t = np.empty(o.shape[0])
    idx = np.empty(o.shape[0], np.int64)

    def rays(s):
        near, far, q, _, _ = _pair64(o[s : s + chunk, None], d[s : s + chunk, None], c, r)
        root = np.where(near > t_min, near, far)
        root = np.where((q >= 0) & (root > t_min) & act, root, np.inf)
        idx[s : s + chunk] = root.argmin(-1)
        t[s : s + chunk] = root.min(-1)

    # NumPy releases the GIL inside array operations: one chunk per core.
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(rays, range(0, o.shape[0], chunk)))
    return t, idx, np.isfinite(t)


def compare_hits(got, o, d, centers, radii, active, t_min=integrator.T_MIN) -> dict:
    """A closest-hit result against :func:`closest_hit64` on the same rays.

    A ray may decide otherwise (another winner, hit against miss) only
    where the reference's decision lies within twice the f32 rounding bound
    of ``_pair64`` of a tie, of the t_min edge or of a tangent
    (``unexplained_mismatch`` counts the rest). Where both pick one sphere,
    t must agree to 1e-6 relative wherever that bound is below 1e-6 of t,
    and to within twice the bound elsewhere: hits on the radius-1000 ground
    sphere round ``oc`` at ~1000 (ulp 6.1e-5), rays that start on a
    surface have t far below |oc| (``t_outside_bound`` counts failures)."""
    t_g, i_g, h_g = (np.asarray(x) for x in got)
    t_g = t_g.astype(np.float64)
    o64, d64 = np.asarray(o, np.float64), np.asarray(d, np.float64)
    c64, r64 = np.asarray(centers, np.float64), np.asarray(radii, np.float64)
    t_w, i_w, h_w = closest_hit64(o64, d64, c64, r64, active, t_min)

    def pair(k):
        near, far, q, err_q, err_t = _pair64(o64, d64, c64[k], r64[k])
        t = np.where(near > t_min, near, far)
        shaky = (np.abs(q) <= 2 * err_q) | (np.abs(near - t_min) <= 2 * err_t) | (
            np.abs(far - t_min) <= 2 * err_t
        )
        # The root that t_g lies nearer to (near root 0, far root 1).
        return t, err_t, shaky, np.abs(t_g - far) < np.abs(t_g - near), far

    tw, err_w, shaky_w, root_g, far_w = pair(i_w)
    tg, err_g, shaky_g, _, _ = pair(i_g)
    # Same decision: the same hit flag and, on a hit, the same sphere and root.
    same = (h_g == h_w) & (~h_w | ((i_g == i_w) & (root_g == (tw == far_w))))
    tie = h_g & h_w & (np.abs(tg - tw) <= 2 * (err_g + err_w))
    explained = (h_w & shaky_w) | (h_g & shaky_g) | tie
    agree = same & h_w
    err = np.abs(t_g - t_w)
    fine = err_w <= 1e-6 * t_w  # f32 can resolve t to 1e-6 here
    ok = np.where(fine, err <= 1e-6 * t_w, err <= 2 * err_w)
    rel = err[agree] / t_w[agree]
    use = err[agree & ~fine] / (2 * err_w[agree & ~fine])
    return dict(
        rays=int(t_w.size),
        hits=int(h_w.sum()),
        decision_mismatch=int((~same).sum()),
        unexplained_mismatch=int((~same & ~explained).sum()),
        hits_resolvable_to_1e6=int((agree & fine).sum()),
        t_rel_max_resolvable=float(rel[fine[agree]].max()) if (agree & fine).any() else 0.0,
        t_rel_over_1e6=int((rel > 1e-6).sum()),
        t_rel_max=float(rel.max()) if rel.size else 0.0,
        t_outside_bound=int((agree & ~ok).sum()),
        bound_use_max=float(use.max()) if use.size else 0.0,
    )


def closest_hit(n_rays: int = 65536, width: int = 1920, stress_copies: int = 16) -> dict:
    """The fused closest-hit against the float64 reference on real book1
    rays, at book1's table (488 rows) and sphere_stress's (7,744 rows at 16
    copies)."""
    out = {}
    for name, make, kw in (
        ("book1", demo.book1_end_scene, {}),
        ("sphere_stress", demo.sphere_stress, dict(copies=stress_copies)),
    ):
        sc, sd, cp = _scene(make, width, **kw)
        o, d = hit_rays(
            sd, cp, sc.scene_cam.image_width, sc.scene_cam.image_height, n_rays
        )
        geom = (sd.sph_center, sd.sph_radius, sd.sph_active)
        got = jax.jit(intersect.hit_spheres)(o, d, *geom, integrator.T_MIN, jnp.inf)
        res = compare_hits(got, o, d, *geom)
        res["rows"] = int(sd.sph_center.shape[0])
        assert res["unexplained_mismatch"] == 0, (name, res)
        assert res["t_outside_bound"] == 0, (name, res)
        out[name] = res
    return out


# --------------------------------------------------------------------------
# Gradient
# --------------------------------------------------------------------------


def _grad_setup(width, spp, depth):
    import optax

    sc, sd, cp = _scene(demo.book1_end_scene, width)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    params = grad_mod.extract_params(sd, cp)
    optimizer = optax.adam(1e-2)
    return sd, cp, w, h, params, optimizer


def train(width: int = 1920, spp: int = 4, depth: int = 8, steps: int = 3) -> dict:
    """``make_train_step`` over the full frame, then one frozen-decision
    step. Prints the train step's ``memory_analysis()``."""
    sd, cp, w, h, params, optimizer = _grad_setup(width, spp, depth)
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    target = jnp.zeros((w * h, 3), jnp.float32)
    step = grad_mod.make_train_step(optimizer, w, h, spp, depth)
    opt_state = optimizer.init(params)
    seed = jnp.uint32(0)
    compiled = step.lower(params, opt_state, sd, cp, target, pix, seed).compile()
    print(f"train step memory_analysis: {compiled.memory_analysis()}", flush=True)
    p, s = jax.tree_util.tree_map(jnp.copy, (params, opt_state))
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, sd, cp, target, pix, jnp.uint32(i))
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(p))

    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    rec = grad_mod.record_decisions(sd, cp, pix, seed, **kw)
    f_loss, f_grads = grad_mod.loss_and_grad(
        params, sd, cp, target, pix, seed, rec=rec, **kw
    )
    f_loss = float(f_loss)
    assert np.isfinite(f_loss)
    assert all(
        np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(f_grads)
    )
    return dict(losses=losses, frozen_loss=f_loss)


def _leaf_rel_l2(got, want) -> dict:
    """Relative L2 error of each parameter leaf group."""
    out = {}
    for name in want:
        a = [np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(got[name])]
        b = [np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(want[name])]
        if not b:
            continue
        a, b = np.concatenate(a), np.concatenate(b)
        nb = np.linalg.norm(b)
        out[name] = float(np.linalg.norm(a - b) / nb) if nb > 0 else float(np.linalg.norm(a))
    return out


# Rounding-level input changes: the camera's position and target, or every
# sphere's center and radius, scaled by 1 +/- 2^-22 and 1 +/- 2^-21.
_NUDGES = tuple(np.float32(1 + s * 2.0**e) for e in (-22, -21) for s in (1, -1))


def rounding_sensitivity(grad_fn, params, sd) -> dict:
    """Per parameter leaf, the largest relative L2 change of
    ``grad_fn(params, sd)[1]`` under the nudges above: how far rounding
    alone moves this gradient estimate on one device. Camera and fuzz
    leaves are dominated by a few rays that graze a sphere (dt/dtheta ~
    1/sqrt(r^2 - l^2)), radiometric leaves by hit points near a checker
    edge, so a 2-ulp nudge moves them far more than f32 summation order."""
    _, g0 = grad_fn(params, sd)
    out = {}
    for f in _NUDGES:
        cam = {k: params[k] * f for k in ("cam_look_from", "cam_look_at")}
        geo = dict(sph_center=sd.sph_center * f, sph_radius=sd.sph_radius * f)
        for p_, sd_ in (({**params, **cam}, sd), (params, sd.replace(**geo))):
            for k, v in _leaf_rel_l2(grad_fn(p_, sd_)[1], g0).items():
                out[k] = max(out.get(k, 0.0), v)
    return out


def _compare_grads(loss, grads, loss_ref, grads_ref, sensitivity) -> dict:
    """The gradient verdict shared by the CPU and the four-card checks: the
    loss agrees to 1e-4 relative, and each leaf to 1e-4 relative L2 or, where
    that is larger, to twice the reference's ``rounding_sensitivity``."""
    rel = _leaf_rel_l2(grads, grads_ref)
    out = dict(
        loss_rel=abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
        grad_rel_l2=rel,
        rounding_sensitivity=sensitivity,
    )
    assert out["loss_rel"] <= 1e-4, out
    for name, r in rel.items():
        assert r <= max(1e-4, 2 * sensitivity[name]), (name, out)
    return out


def grad_vs_cpu(
    width: int = 1920, n_pixels: int = 65536, spp: int = 4, depth: int = 8,
    seed: int = 0,
) -> dict:
    """``loss_and_grad`` over a pixel subset of the batch on the default
    device and on the CPU device.

    The record pass runs on each device and its decisions are compared
    lane by lane: only f32 contraction differs, so a lane may take another
    path where a hit or a scatter branch sits within rounding of its
    bound — the silhouette flips of ``forward_vs_cpu``, held to the same
    3%. The gradients are then compared on the same records
    (``loss_and_grad(rec=...)``), so no decision differs, and held to
    ``_compare_grads`` with the CPU's own rounding sensitivity."""
    sd, cp, w, h, params, _ = _grad_setup(width, spp, depth)
    pix = np.sort(
        np.random.default_rng(seed).choice(w * h, n_pixels, replace=False)
    ).astype(np.uint32)
    target = np.zeros((n_pixels, 3), np.float32)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    cpu = cpu_device()
    s0 = np.uint32(seed)
    rec = grad_mod.record_decisions(sd, cp, pix, s0, **kw)
    rec_c = grad_mod.record_decisions(*jax.device_put((sd, cp, pix), cpu), s0, **kw)
    lanes_differ = float(np.any(np.asarray(rec) != np.asarray(rec_c), axis=0).mean())
    l_d, g_d = grad_mod.loss_and_grad(params, sd, cp, target, pix, s0, rec=rec, **kw)
    cp_c, target_c, pix_c, rec_dc = jax.device_put((cp, target, pix, rec), cpu)

    def on_cpu(p_, sd_):
        p_, sd_ = jax.device_put((p_, sd_), cpu)
        return grad_mod.loss_and_grad(p_, sd_, cp_c, target_c, pix_c, s0, rec=rec_dc, **kw)

    l_c, g_c = on_cpu(params, sd)
    out = dict(
        record_lanes_differ=lanes_differ,
        **_compare_grads(l_d, g_d, l_c, g_c, rounding_sensitivity(on_cpu, params, sd)),
    )
    assert lanes_differ < 0.03, out
    return out


# --------------------------------------------------------------------------
# Movie
# --------------------------------------------------------------------------


def movie(out_dir: Path, frames: int = 2) -> dict:
    """``frames`` frames of the first movie (animated camera, HDR sky)."""
    fps = 24.0
    sc = demo.first_movie(frame_rate=fps, duration=frames / fps)
    times = []
    path = render.render_movie(
        sc, str(out_dir / "first_movie"), verbose=False,
        on_frame=lambda fi, dt: times.append(dt),
    )
    from crucible_tpu.io.image import read_ppm

    art = out_dir / "first_movie" / "artifacts"
    imgs = sorted(art.glob("image*.ppm"))
    assert len(imgs) == frames and len(times) == frames, (imgs, times)
    a, b = read_ppm(imgs[0]), read_ppm(imgs[-1])
    assert a.std() > 5 and b.std() > 5
    assert (a != b).any(), "the animated camera did not move"
    return dict(frames=len(imgs), frame_seconds=times, output=str(path))


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------


def _best_seconds(fn, runs=2):
    """Run ``fn`` once to compile, then return its fastest of ``runs``."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def four_cards(
    width: int = 1920, still_spp: int = 32, still_depth: int = 50,
    grad_width: int = 1920, n_pixels: int = 65536, spp: int = 4, depth: int = 8,
) -> dict:
    """The sharded paths over a mesh of every card, against one card. The
    sharded still (book1 at the CLI's 32 spp and depth 50) must equal
    ``render.render_image`` on one card, the production route, to the bit;
    both are timed. The sharded record pass is compared with one card's
    lane by lane, and the sharded gradient over one card's records is held
    to ``_compare_grads``; then one sharded train step runs."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from crucible_tpu.parallel import mesh as mesh_mod
    from crucible_tpu.parallel.render import render_image_sharded

    n = len(jax.devices())
    mesh = mesh_mod.make_mesh(n)
    sc = demo.book1_end_scene(width=width)
    still = dict(samples=still_spp, max_depth=still_depth)
    sharded = render_image_sharded(sc, mesh, **still)
    single = render.render_image(sc, **still)
    identical = bool((single == sharded).all())
    assert identical, (
        "sharded still differs from one card in "
        f"{float(np.any(single != sharded, axis=-1).mean()):.3%} of pixels"
    )
    still_seconds = dict(
        one_card=_best_seconds(lambda: render.render_image(sc, **still)),
        sharded=_best_seconds(lambda: render_image_sharded(sc, mesh, **still)),
    )

    sd, cp, w, h, params, optimizer = _grad_setup(grad_width, spp, depth)
    pix = np.arange(n_pixels, dtype=np.uint32) * np.uint32((w * h) // n_pixels)
    target = np.zeros((n_pixels, 3), np.float32)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    one = jax.devices()[0]
    seed = jnp.uint32(0)
    single_args = jax.device_put((params, sd, cp, target, pix), one)
    rec1 = grad_mod.record_decisions(*single_args[1:3], single_args[4], seed, **kw)
    l1, g1 = grad_mod.loss_and_grad(*single_args, seed, rec=rec1, **kw)
    rep = mesh_mod.replicated(mesh)
    args_r = jax.device_put((params, sd, cp), rep)
    pix_s = jax.device_put(pix, mesh_mod.pixel_sharding(mesh))
    tgt_s = jax.device_put(target, mesh_mod.pixel_sharding(mesh))
    rec_n = grad_mod.record_decisions(*args_r[1:], pix_s, seed, **kw)
    lanes_differ = float(np.any(np.asarray(rec_n) != np.asarray(rec1), axis=0).mean())
    # Same records on both sides: what differs is the order of the sums.
    rec_s = jax.device_put(
        np.asarray(rec1), NamedSharding(mesh, P(None, mesh_mod.DP_AXIS))
    )
    l2, g2 = grad_mod.loss_and_grad(*args_r, tgt_s, pix_s, seed, rec=rec_s, **kw)

    def on_one(p_, sd_):
        p_, sd_ = jax.device_put((p_, sd_), one)
        return grad_mod.loss_and_grad(
            p_, sd_, *single_args[2:], seed, rec=rec1, **kw
        )

    out = dict(
        devices=n, still_identical_to_one_card=identical,
        still_seconds=still_seconds,
        record_lanes_differ=lanes_differ,
        **_compare_grads(l2, g2, l1, g1, rounding_sensitivity(on_one, params, sd)),
    )
    assert lanes_differ < 0.03, out

    step = grad_mod.make_train_step(optimizer, w, h, spp, depth)
    opt_r = jax.device_put(optimizer.init(params), rep)
    _, _, loss = step(*args_r[:1], opt_r, *args_r[1:], tgt_s, pix_s, jnp.uint32(0))
    out["train_step_loss"] = float(loss)
    assert np.isfinite(out["train_step_loss"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded paths over four cards, against one card",
    )
    args = ap.parse_args(argv)

    devices = backend.require_gpu()
    backend.configure_compile_cache()
    results = {}
    if args.four_cards:
        assert len(devices) == 4, f"--four-cards needs 4 GPUs, found {len(devices)}"
        with phase("four_cards"):
            results["four_cards"] = four_cards()
    else:
        with tempfile.TemporaryDirectory(
            prefix=".smoke_", dir=backend.checkout_dir()
        ) as tmp:
            out_dir = Path(tmp)
            with phase("forward"):
                results["forward"] = forward_cli(out_dir)
            with phase("forward_vs_cpu"):
                results["forward_vs_cpu"] = forward_vs_cpu()
            with phase("closest_hit"):
                results["closest_hit"] = closest_hit()
            with phase("train"):
                results["train"] = train()
            with phase("grad_vs_cpu"):
                results["grad_vs_cpu"] = grad_vs_cpu()
            with phase("movie"):
                results["movie"] = movie(out_dir)
    for name, res in results.items():
        print(f"{name}: {json.dumps(res, default=str)}", flush=True)
    print(card_name_and_power(), flush=True)
    d = jax.devices()[0]
    print(json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(jax.devices())}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
