"""Vectorized BSDFs over a SoA material table.

The reference dispatches ``Materials::scatter`` over a closed enum
{Lambertian, Metal, Dielectric} (src/materials/mod.rs:16-38). Here materials
are integer-typed rows of a parameter table and all three scatter programs
evaluate branch-free on the whole wavefront, combined with ``jnp.where`` —
the data-parallel form of static dispatch.

Extension beyond the reference (per BASELINE.json "emission" gradients): an
EMISSIVE material type whose radiance contribution is
``throughput * emission`` on hit, after which the path terminates.
"""

from __future__ import annotations

import jax.numpy as jnp

from crucible_tpu.ops import sampling
from crucible_tpu.utils import vec

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


def schlick(cosine, ri):
    """Schlick's reflectance approximation
    (src/materials/dielectric.rs:21-26)."""
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(
    mat_type,
    fuzz,
    ior,
    scatter_prob,
    albedo,
    d_in,
    normal,
    front_face,
    u_dir1,
    u_dir2,
    u_decide,
    forced_reflect=None,
    forced_degenerate=None,
    return_decisions: bool = False,
):
    """Evaluate all BSDF branches for a wavefront of hits and select by type.

    Args:
      mat_type: (R,) int32 in {LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE}.
      fuzz, ior, scatter_prob: (R,) gathered material params.
      albedo: (R, 3) texture-evaluated albedo at the hit.
      d_in: (R, 3) incoming ray direction (unnormalized, as cast).
      normal: (R, 3) unit outward-flipped surface normal (front-face
        convention of HitRecord, src/objects/mod.rs:65-87).
      front_face: (R,) bool.
      u_dir1, u_dir2: uniforms for the scatter-direction sample.
      u_decide: uniform for the material decision (Lambertian
        Russian-roulette / dielectric reflectance test).
      forced_reflect, forced_degenerate: optional (R,) bool — replace the
        computed dielectric reflect / Lambertian degenerate decisions with
        recorded ones (the replay gradient path freezes every discrete
        decision so ulp drift in recomputed continuous values can never
        flip a branch — crucible_tpu/models/replay.py).
      return_decisions: also return the decision booleans.

    Returns:
      (scatter_dir (R,3), attenuation (R,3), scattered (R,) bool)
      ``scattered`` False means the path is absorbed
      (``Material::scatter -> None`` in the reference).
      With ``return_decisions``: a 4th element, dict with ``reflect`` and
      ``degenerate`` (R,) bool.
    """
    rnd_unit = sampling.unit_vector(u_dir1, u_dir2)

    # --- Lambertian (src/materials/lambertian.rs:40-61) -------------------
    lam_dir = normal + rnd_unit
    degenerate = (
        forced_degenerate
        if forced_degenerate is not None
        else vec.near_zero(lam_dir)
    )
    lam_dir = jnp.where(degenerate[:, None], normal, lam_dir)
    # Russian-roulette with 1/p compensation; all demo scenes pass prob=1.0.
    lam_atten = albedo / jnp.maximum(scatter_prob, 1e-8)[:, None]
    lam_alive = u_decide <= scatter_prob

    # --- Metal (src/materials/metal.rs:29-42) -----------------------------
    reflected = vec.reflect(d_in, normal)
    met_dir = vec.unit(reflected, eps=1e-20) + fuzz[:, None] * rnd_unit
    met_alive = vec.dot(met_dir, normal) > 0.0
    met_atten = albedo

    # --- Dielectric (src/materials/dielectric.rs:29-56) -------------------
    ud = vec.unit(d_in, eps=1e-20)
    ri = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vec.dot(-ud, normal), 1.0)
    # 1e-12 floor keeps d(sqrt) finite at grazing/normal incidence for AD.
    sin_theta = jnp.sqrt(jnp.maximum(1.0e-12, 1.0 - cos_theta * cos_theta))
    cannot_refract = ri * sin_theta > 1.0
    reflect_choice = (
        forced_reflect
        if forced_reflect is not None
        else cannot_refract | (schlick(cos_theta, ri) > u_decide)
    )
    die_dir = jnp.where(
        reflect_choice[:, None],
        vec.reflect(ud, normal),
        vec.refract(ud, normal, ri),
    )
    die_atten = jnp.ones_like(albedo)

    # --- select by type ---------------------------------------------------
    is_metal = (mat_type == METAL)[:, None]
    is_diel = (mat_type == DIELECTRIC)[:, None]
    is_emissive = mat_type == EMISSIVE

    out_dir = jnp.where(is_diel, die_dir, jnp.where(is_metal, met_dir, lam_dir))
    atten = jnp.where(is_diel, die_atten, jnp.where(is_metal, met_atten, lam_atten))
    alive = jnp.where(
        mat_type == DIELECTRIC,
        True,
        jnp.where(mat_type == METAL, met_alive, lam_alive),
    )
    alive = alive & ~is_emissive  # emitters terminate the path
    if return_decisions:
        return out_dir, atten, alive, dict(
            reflect=reflect_choice, degenerate=degenerate
        )
    return out_dir, atten, alive
