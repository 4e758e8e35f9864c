"""Checks that need the card (marker ``gpu``; the ``gpu`` fixture skips them
elsewhere). Run on a GPU host with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from crucible_tpu.models import demo, integrator
from crucible_tpu.models.camera import generate_rays
from crucible_tpu.ops import intersect

pytestmark = pytest.mark.gpu


def test_closest_hit_fused_on_card(gpu):
    """At 1080p book1 primary rays the fused closest-hit agrees with the
    float64 reference, and its compiled program holds no (rays, spheres)
    buffer: temporaries stay below one such f32 array."""
    sc = demo.book1_end_scene(width=1920)
    sd, cp = sc.build(), sc.scene_cam.params()
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    o, d, _ = generate_rays(cp, w, h, pix, jnp.zeros_like(pix), jnp.uint32(0))
    args = (sd.sph_center, sd.sph_radius, sd.sph_active, integrator.T_MIN, jnp.inf)
    fused = jax.jit(intersect.hit_spheres)
    res = chip_smoke.compare_hits(
        fused(o, d, *args), o, d, sd.sph_center, sd.sph_radius, sd.sph_active
    )
    assert res["unexplained_mismatch"] == 0 and res["t_outside_bound"] == 0, res
    mem = fused.lower(o, d, *args).compile().memory_analysis()
    assert mem.temp_size_in_bytes < w * h * sd.sph_center.shape[0] * 4


def test_forward_route_matches_cpu(gpu):
    out = chip_smoke.forward_vs_cpu(width=480, spp=4, depth=50, n_pixels=1024)
    assert out["frac_over_1e3"] < 0.03


def test_gradient_matches_cpu(gpu):
    out = chip_smoke.grad_vs_cpu(width=480, n_pixels=16384, spp=4, depth=8)
    assert out["loss_rel"] <= 1e-4
