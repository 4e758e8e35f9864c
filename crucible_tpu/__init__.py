"""crucible_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch re-imagination of the Rust CPU renderer kylittle/Crucible
(see SURVEY.md) for accelerators, running on NVIDIA GPUs:

- SoA scene representation as JAX pytrees (no object enums / dyn dispatch).
- Wavefront path integrator: an iterative bounce loop over a flat ray batch
  with masked live rays, replacing the reference's recursive ``ray_color``
  (reference: src/camera/ray_casting.rs:112-152).
- Brute-force sphere intersection as one fused closest-hit reduction and a
  stackless skip-link BVH for triangle meshes.
- Counter-based RNG (PCG4D) keyed by (pixel, sample, stream, seed) so renders
  are bit-deterministic regardless of device count or sharding.
- Differentiable radiance w.r.t. material albedo, texture texels, emission,
  skybox images and camera parameters.
- Multi-device scaling: gradient batches sharded over a ``jax.sharding.Mesh``
  with ``psum``-reduced gradients; stills as pixel chunks spread over the
  devices, scene replicated.

Default compute dtype is float32 (the reference uses f64 on CPU; f64 on GPUs
runs at a fraction of the f32 rate — an intentional, documented deviation).
"""

__version__ = "0.1.0"

from crucible_tpu.models.scene import (  # noqa: F401
    CheckerTexture,
    Dielectric,
    Emissive,
    ImageTexture,
    Lambertian,
    Metal,
    Scene,
    SceneData,
    SolidColor,
    Sphere,
    Triangle,
)
from crucible_tpu.models.camera import Camera  # noqa: F401
from crucible_tpu.models import demo  # noqa: F401
