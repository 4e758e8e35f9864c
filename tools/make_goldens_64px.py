"""Generate the 64px golden references (tests/goldens/golden_64px_v2.npz).

CPU tiled renders (the semantic reference path) of eight demo worlds at
64px / 8 spp / depth 8, seed 0 — larger than the 32px CI goldens, and
covering worlds those omit (teapot BVH mesh, garden equirect HDR sky,
sphere_stress, nested checkers) — plus one depth-50 image through the deep
gradient path's forward (``book1_deep50``).

Regenerate ONLY on an intentional semantic change:
    python tools/make_goldens_64px.py
Each entry is printed beside its difference from the previous goldens
(golden_64px_v1.npz): the fraction of values off by more than 1e-3 and the
mean absolute difference.
"""

from __future__ import annotations

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import numpy as np

SPP = 8
DEPTH = 8
GOLDENS = Path(__file__).resolve().parent.parent / "tests" / "goldens"
OUT = GOLDENS / "golden_64px_v2.npz"
PREVIOUS = GOLDENS / "golden_64px_v1.npz"

# (builder name, width, spp) — garden's demo defaults to 1920w; pin it
# small. Teapot runs 32 spp: more samples average its ulp-flipped
# silhouette samples down when another platform is compared to it.
WORLDS = (
    ("smoke_scene", 64, SPP),
    ("book1_end_scene", 64, SPP),
    ("checkered_spheres", 64, SPP),
    ("earth", 64, SPP),
    ("load_teapot", 64, 32),
    ("garden_skybox", 64, SPP),
    # Large sphere table + deep nested checkers.
    ("sphere_stress", 64, SPP),
    ("nested_checkers", 64, SPP),
)

# A DEPTH-50 config through the deep-GRADIENT forward path (two-level
# record + depth-bucketed replay).
DEEP_WORLD = ("book1_end_scene", 64, SPP, 50)
DEEP_KEY = "book1_deep50"


def deep_replay_image(width=64, spp=SPP, depth=50, seed=0):
    """Per-pixel mean radiance through the DEEP gradient path's forward:
    render_rays_replay with lane-narrowing forced on (two-level record +
    depth-bucketed replay). This is the exact estimator the grad500
    headline differentiates."""
    import jax.numpy as jnp

    from crucible_tpu.models import demo
    from crucible_tpu.models import replay as replay_mod

    sc = getattr(demo, DEEP_WORLD[0])(width=width)
    sd = sc.build()
    cp = sc.scene_cam.params()
    h = sc.scene_cam.image_height
    p = width * h
    pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
    smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
    rad = replay_mod.render_rays_replay(
        sd, cp, width, h, pix, smp, jnp.uint32(seed), depth, split=True
    )
    return np.asarray(
        rad.reshape(spp, p, 3).mean(axis=0).reshape(h, width, 3), np.float32
    )


def main():
    from crucible_tpu.models import demo, render

    previous = np.load(PREVIOUS)

    def report(name, arr):
        diff = np.abs(arr - previous[name])
        print(
            f"{name}: {arr.shape} mean={arr.mean():.4f} max={arr.max():.4f} "
            f"vs previous: >1e-3 {(diff > 1e-3).mean():.4f} "
            f"mean abs {diff.mean():.2e}"
        )

    out = {}
    for name, width, spp in WORLDS:
        sc = getattr(demo, name)(width=width)
        img = render.render_image(
            sc, samples=spp, max_depth=DEPTH, seed=0, mode="tiled"
        )
        out[name] = np.asarray(img, np.float32)
        report(name, out[name])
    out[DEEP_KEY] = deep_replay_image(DEEP_WORLD[1], DEEP_WORLD[2], DEEP_WORLD[3])
    report(DEEP_KEY, out[DEEP_KEY])
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
