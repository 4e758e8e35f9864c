"""Differentiable rendering: parameter pytrees, losses, and train steps.

BASELINE acceptance: pixel gradients w.r.t. material albedo, texture texels,
emission, and camera parameters must pass finite-difference checks. The
integrator keeps continuous radiance terms on the autodiff tape and detaches
discrete sampling decisions (models/integrator.py docstring), so interior
gradients here are the standard detached-sampling estimator.

The train step is the inverse-rendering workhorse: given target images,
optimize scene parameters by gradient descent. Under a sharded jit the
per-shard gradients are psum-reduced by XLA automatically.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from crucible_tpu.models import integrator
from crucible_tpu.models.camera import CameraParams
from crucible_tpu.models.scene import SceneData


def extract_params(sd: SceneData, cp: CameraParams) -> Dict[str, Any]:
    """Pull the differentiable leaves out of (scene, camera) as a flat dict —
    the optimization variables for inverse rendering."""
    return {
        "tex_color": sd.tex.color,  # solid/checker albedos
        "tex_images": sd.tex.images,  # texture texels
        "mat_emission": sd.mat_emission,
        "mat_fuzz": sd.mat_fuzz,
        "sky_image": sd.sky_image,
        "cam_look_from": cp.look_from,
        "cam_look_at": cp.look_at,
        "cam_vfov": cp.vfov_rad,
        "cam_defocus": cp.defocus_angle_rad,
        "cam_focus_dist": cp.focus_dist,
    }


def apply_params(sd: SceneData, cp: CameraParams, p: Dict[str, Any]):
    """Write a parameter dict back into (scene, camera) pytrees."""
    sd = sd.replace(
        tex=sd.tex.replace(color=p["tex_color"], images=tuple(p["tex_images"])),
        mat_emission=p["mat_emission"],
        mat_fuzz=p["mat_fuzz"],
        sky_image=p["sky_image"],
    )
    cp = cp.replace(
        look_from=p["cam_look_from"],
        look_at=p["cam_look_at"],
        vfov_rad=p["cam_vfov"],
        defocus_angle_rad=p["cam_defocus"],
        focus_dist=p["cam_focus_dist"],
    )
    return sd, cp


def render_pixels_mean(
    params,
    sd: SceneData,
    cp: CameraParams,
    pixel_ids,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    method: str = "auto",
    sample0=0,
    rec=None,
    grad_spec=None,
    grad_record_div: int | None = None,
    grad_split: bool | None = None,
):
    """Per-pixel mean radiance (P, 3) for the given pixels, differentiable
    w.r.t. ``params``.

    ``method``: 'replay' (record fast forward, differentiate the O(R*depth)
    decision replay — models/replay.py, the fast gradient path), 'ad'
    (direct reverse-mode through the checkpointed bounce scan — the
    semantic reference), or 'auto' (replay whenever the scene supports it).
    """
    from crucible_tpu.models import replay as replay_mod

    sd, cp = apply_params(sd, cp, params)
    if method == "auto":
        if replay_mod.replay_supported(sd):
            method = "replay"
        else:
            import sys

            print(
                "crucible_tpu: WARNING: scene outside replay-gradient "
                "coverage (see replay.replay_supported); using the direct-AD "
                "estimator (slower, memory-heavy at large pixel batches)",
                file=sys.stderr,
            )
            method = "ad"
    if rec is not None and method != "replay":
        # Silently dropping precomputed records would turn a frozen-decision
        # training loop into full re-decision AD steps (ADVICE r3).
        raise ValueError(
            "precomputed decision records (rec=...) require the replay "
            f"gradient path, but method resolved to {method!r} — this scene "
            "is outside replay coverage (replay.replay_supported)"
        )
    p = pixel_ids.shape[0]
    pix = jnp.tile(pixel_ids, spp)
    smp = jnp.repeat(
        jnp.asarray(sample0, jnp.uint32) + jnp.arange(spp, dtype=jnp.uint32), p
    )
    if method == "replay":
        rad = replay_mod.render_rays_replay(
            sd, cp, width, height, pix, smp, seed, max_depth, rec=rec,
            split=grad_split, spec=grad_spec, record_div=grad_record_div,
        )
    else:
        rad = integrator.render_rays(
            sd, cp, width, height, pix, smp, seed, max_depth, differentiable=True
        )
    return rad.reshape(spp, p, 3).mean(axis=0)


@partial(
    jax.jit, static_argnames=("width", "height", "spp", "max_depth")
)
def record_decisions(
    sd: SceneData,
    cp: CameraParams,
    pixel_ids,
    seed,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    sample0=0,
):
    """Precompute the packed decision records for a pixel/sample batch —
    the reusable half of FROZEN-DECISION training.

    Path decisions (winner ids, scatter branches, termination) depend on
    geometry, material scalars and the camera, NOT on albedo, emission or
    texel values — so radiometric-parameter optimization can record once
    and run many replay-only gradient steps (``loss_and_grad(..., rec=...)``),
    re-recording when fuzz/camera parameters drift or a fresh sample window
    is wanted.
    """
    from crucible_tpu.models import replay as replay_mod

    p = pixel_ids.shape[0]
    pix = jnp.tile(pixel_ids, spp)
    smp = jnp.repeat(
        jnp.asarray(sample0, jnp.uint32) + jnp.arange(spp, dtype=jnp.uint32), p
    )
    from crucible_tpu.models.camera import generate_rays

    o, d, _ = generate_rays(cp, width, height, pix, smp, seed)
    return replay_mod.trace_record(sd, o, d, pix, smp, seed, max_depth)


_L2_STATICS = (
    "width", "height", "spp", "max_depth", "method",
    "grad_spec", "grad_record_div", "grad_split",
)


@partial(jax.jit, static_argnames=_L2_STATICS)
def l2_loss(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, method="auto", sample0=0, rec=None,
    grad_spec=None, grad_record_div=None, grad_split=None,
):
    """Mean squared error against target pixel radiances.

    ``sample0`` (traced) offsets the sample ids — the knob behind
    :func:`loss_and_grad_accum`'s sample-chunked gradient accumulation.
    ``rec``: precomputed decision records (:func:`record_decisions`) for
    frozen-decision steps; decisions then stay fixed while radiometric
    params move. ``grad_spec``/``grad_record_div``/``grad_split``: static
    deep-replay capacity overrides (the overflow-recovery ladder).
    """
    img = render_pixels_mean(
        params, sd, cp, pixel_ids, width, height, spp, max_depth, seed,
        method=method, sample0=sample0, rec=rec,
        grad_spec=grad_spec, grad_record_div=grad_record_div,
        grad_split=grad_split,
    )
    return jnp.mean((img - target) ** 2)


loss_and_grad = jax.jit(
    jax.value_and_grad(l2_loss), static_argnames=_L2_STATICS
)


# Capacity-overflow recovery ladder: each rung recompiles the chunk with
# wider static capacities. Rung 0 = the defaults; widen k halves every
# bucket divisor and the narrow-record divisor by k (doubling capacities);
# the last rung abandons lane-narrowing entirely (always correct, the
# memory-heaviest). The reference panics on contract violations
# (src/utils.rs:346-351); here the guards NaN-poison loudly and THIS ladder
# is the recovery the reference never had.
_RECOVERY_LADDER = ("default", 2, 4, "unsplit")


def _ladder_kwargs(rung):
    from crucible_tpu.models import replay as replay_mod

    if rung == "default":
        return {}
    if rung == "unsplit":
        return {"grad_split": False}
    spec = tuple(
        (lim, max(1, dv // rung)) for lim, dv in replay_mod.GRAD_BUCKET_SPEC
    )
    div = max(1, replay_mod.RECORD_DEEP_DIV // rung)
    return {"grad_spec": spec, "grad_record_div": div}


def loss_and_grad_recovering(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, method="auto", sample0=0, rec=None,
    verbose=True, start=0,
):
    """:func:`loss_and_grad` with automatic capacity-overflow recovery.

    The deep-gradient path's static lane-narrowing capacities NaN-poison
    loudly when a scene's survivor fraction exceeds them
    (models/replay.py) — correct, but it used to kill long training runs
    at chunk N with only env knobs as the escape hatch (VERDICT r4 #4).
    This wrapper detects the poisoned chunk (non-finite loss) and retries
    it up the ladder: doubled capacities (x2, x4), then the unsplit
    full-width replay. Each retry recompiles once and is logged loudly;
    if even the unsplit replay is non-finite the NaN is NOT a capacity
    overflow and an actionable error names the knobs.
    """
    import sys

    for i, rung in enumerate(_RECOVERY_LADDER[start:]):
        kw = _ladder_kwargs(rung)
        loss, g = loss_and_grad(
            params, sd, cp, target, pixel_ids, seed,
            width=width, height=height, spp=spp, max_depth=max_depth,
            method=method, sample0=sample0, rec=rec, **kw,
        )
        if bool(np.isfinite(float(loss))):
            if i and verbose:
                print(
                    f"crucible_tpu: recovered from deep-replay capacity "
                    f"overflow at ladder rung {rung!r} ({kw}) — consider "
                    f"setting CRUCIBLE_GRAD_BUCKETS/CRUCIBLE_RECORD_DEEP_DIV "
                    f"or split=False permanently for this scene",
                    file=sys.stderr,
                )
            return loss, g
        if verbose:
            print(
                f"crucible_tpu: WARNING: non-finite chunk loss at ladder "
                f"rung {rung!r} (sample0={int(np.asarray(sample0))}) — "
                f"retrying with wider deep-replay capacities",
                file=sys.stderr,
            )
    raise FloatingPointError(
        "loss is non-finite even with the full-width (unsplit) replay — "
        "this is NOT a lane-narrowing capacity overflow. Check scene "
        "parameters for NaN sources (negative radii, zero-length camera "
        "axes); the capacity knobs (CRUCIBLE_GRAD_BUCKETS, "
        "CRUCIBLE_RECORD_DEEP_DIV, split=) cannot help here."
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "method"),
    donate_argnums=(7, 8),
)
def _accum_chunk(
    params, sd, cp, target, pixel_ids, seed, sample0, total, loss_sum,
    *, width, height, spp, max_depth, method,
):
    """One fused accumulation step: chunk loss_and_grad + the running-sum
    update in a SINGLE dispatch (no eager tree_map adds between chunks)."""
    loss, g = jax.value_and_grad(l2_loss)(
        params, sd, cp, target, pixel_ids, seed,
        width=width, height=height, spp=spp, max_depth=max_depth,
        method=method, sample0=sample0,
    )
    total = jax.tree_util.tree_map(lambda a, b: a + b, total, g)
    return loss_sum + loss, total


@partial(jax.jit, donate_argnums=(0, 1))
def _fold_chunk(total, loss_sum, g, loss):
    """Fold one checked chunk gradient into the running sums (ONE
    dispatch; the donated buffers keep accumulation allocation-free)."""
    total = jax.tree_util.tree_map(lambda a, b: a + b, total, g)
    return total, loss_sum + loss


def loss_and_grad_accum(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, chunk_spp, method="auto",
    recover=True,
):
    """Sample-chunked gradient accumulation: averages ``spp / chunk_spp``
    minibatch (chunk-loss) gradients, each from an independent sample
    window. This is how deep-budget configs (book1 1080p 500 spp) train
    without materializing a 500-sample record buffer: the decision records
    exist one chunk at a time. ``sample0`` is traced, so every chunk reuses
    ONE compiled executable.

    Note the objective is the MEAN OF CHUNK LOSSES (standard minibatch
    SGD over sample windows), not the L2 of the all-sample mean image.
    The two coincide as chunk_spp -> spp; at smaller chunks the expectation
    E[chunk MSE] = MSE of the true mean image + Var(chunk estimator) /
    chunk_spp, i.e. the objective is a variance-penalized minibatch MSE.
    Minimizers coincide only when the estimator variance is parameter-
    independent; parameters that modulate variance (fuzz/roughness) feel
    an extra variance-reducing pull, as in any minibatch MC objective
    (ADVICE r3).

    ``recover=True`` (default) checks each chunk's loss for the deep
    replay's NaN capacity poison and re-runs only the poisoned chunk up
    the recovery ladder (:func:`loss_and_grad_recovering`) — the check is
    LAG-1 pipelined (chunk k+1 is dispatched before chunk k's scalar loss
    is fetched) so the device never idles on the host round-trip.
    ``recover=False`` keeps the r4 fully-fused accumulation (zero
    per-chunk host syncs, no recovery).
    """
    assert spp % chunk_spp == 0, (spp, chunk_spp)
    n = spp // chunk_spp
    kw = dict(
        width=width, height=height, spp=chunk_spp, max_depth=max_depth,
        method=method,
    )
    total = jax.tree_util.tree_map(jnp.zeros_like, params)
    loss_sum = jnp.float32(0.0)
    if not recover:
        for s0 in range(0, spp, chunk_spp):
            loss_sum, total = _accum_chunk(
                params, sd, cp, target, pixel_ids, seed, jnp.uint32(s0),
                total, loss_sum, **kw,
            )
        inv = 1.0 / n
        return loss_sum * inv, jax.tree_util.tree_map(
            lambda a: a * inv, total
        )

    def fold(pending, total, loss_sum):
        s0, loss_c, g_c = pending
        if not bool(np.isfinite(float(loss_c))):
            import sys

            print(
                f"crucible_tpu: WARNING: chunk sample0={s0} NaN-poisoned "
                f"(deep-replay capacity overflow) — recovering",
                file=sys.stderr,
            )
            loss_c, g_c = loss_and_grad_recovering(
                params, sd, cp, target, pixel_ids, seed,
                sample0=jnp.uint32(s0), start=1, **kw,
            )
        return _fold_chunk(total, loss_sum, g_c, loss_c)

    pending = None
    for s0 in range(0, spp, chunk_spp):
        loss_c, g_c = loss_and_grad(
            params, sd, cp, target, pixel_ids, seed,
            sample0=jnp.uint32(s0), **kw,
        )
        if pending is not None:
            total, loss_sum = fold(pending, total, loss_sum)
        pending = (s0, loss_c, g_c)
    total, loss_sum = fold(pending, total, loss_sum)
    inv = 1.0 / n
    return loss_sum * inv, jax.tree_util.tree_map(lambda a: a * inv, total)


def make_train_step(
    optimizer, width: int, height: int, spp: int, max_depth: int,
    recover: bool = False,
):
    """Build a jitted optimization step over the parameter dict.

    ``optimizer`` is any optax GradientTransformation. Returns
    ``step(params, opt_state, sd, cp, target, pixel_ids, seed) ->
    (params, opt_state, loss)``.

    ``recover=True`` splits the step into loss_and_grad + a jitted apply
    so a NaN-poisoned deep chunk retries up the capacity ladder
    (:func:`loss_and_grad_recovering`) instead of corrupting the
    parameters; it costs one scalar fetch per step.
    """

    @partial(jax.jit, donate_argnums=(0, 1))
    def apply(params, opt_state, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state

    if recover:
        def step(params, opt_state, sd, cp, target, pixel_ids, seed):
            loss, grads = loss_and_grad_recovering(
                params, sd, cp, target, pixel_ids, seed,
                width=width, height=height, spp=spp, max_depth=max_depth,
            )
            params, opt_state = apply(params, opt_state, grads)
            return params, opt_state, loss

        return step

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, sd, cp, target, pixel_ids, seed):
        loss, grads = jax.value_and_grad(l2_loss)(
            params,
            sd,
            cp,
            target,
            pixel_ids,
            seed,
            width=width,
            height=height,
            spp=spp,
            max_depth=max_depth,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return step


# --------------------------------------------------------------------------
# Checkpoint / resume (SURVEY.md §5: per-frame / per-gradient-step
# checkpoints are a stated BASELINE config; the reference has none)
# --------------------------------------------------------------------------


def save_checkpoint(path, params, opt_state=None, step: int = 0) -> None:
    """Persist a parameter pytree (+ optional optimizer state) to an .npz.

    Plain NumPy container — no orbax dependency, resumable across hosts.
    """
    import pickle

    flat, treedef = jax.tree_util.tree_flatten(params)
    payload = {f"p{i}": np.asarray(l) for i, l in enumerate(flat)}
    payload["__step__"] = np.asarray(step)
    payload["__treedef__"] = np.frombuffer(
        pickle.dumps(treedef), dtype=np.uint8
    )
    if opt_state is not None:
        oflat, otreedef = jax.tree_util.tree_flatten(opt_state)
        for i, l in enumerate(oflat):
            payload[f"o{i}"] = np.asarray(l)
        payload["__otreedef__"] = np.frombuffer(pickle.dumps(otreedef), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_checkpoint(path):
    """-> (params, opt_state | None, step)."""
    import pickle

    with np.load(path, allow_pickle=False) as z:
        treedef = pickle.loads(z["__treedef__"].tobytes())
        n = len([k for k in z.files if k.startswith("p")])
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[f"p{i}"]) for i in range(n)]
        )
        opt_state = None
        if "__otreedef__" in z.files:
            otreedef = pickle.loads(z["__otreedef__"].tobytes())
            m = len([k for k in z.files if k.startswith("o")])
            opt_state = jax.tree_util.tree_unflatten(
                otreedef, [jnp.asarray(z[f"o{i}"]) for i in range(m)]
            )
        return params, opt_state, int(z["__step__"])
