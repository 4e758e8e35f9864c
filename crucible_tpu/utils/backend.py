"""Per-platform route decisions and the persistent compile cache.

One table says which path each platform takes; every driver reads it here
instead of testing the backend string itself. Scene data never depends on
the platform.

- ``cpu`` is for tests: lockstep tiles (``render._render_tile``), small
  wavefronts.
- ``gpu`` takes the XLA routes: the persistent wavefront
  (``integrator.trace_persistent``) for stills and movie frames.

Gradients take the same route on both: the staged ``replay.trace_record``
followed by the jnp replay. Any other platform raises.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import jax

# Exact per-ray-time scenes gather (R, K, 3) timeline tracks in every leaf
# test; their persistent wavefront is capped at this many lanes.
EXACT_MOTION_MAX_LANES = 1 << 16


@dataclasses.dataclass(frozen=True)
class Route:
    """How one platform renders.

    ``forward``: 'tiled' (lockstep tiles of ``rays_per_pass`` rays) or
    'persistent' (one dispatch, ``lanes`` lanes regenerating samples).
    """

    forward: str
    rays_per_pass: int
    lanes: int


ROUTES = {
    "cpu": Route(forward="tiled", rays_per_pass=1 << 13, lanes=1 << 13),
    # 2^20 lanes: book1 at 1080p has 2.07 M pixels, so the persistent
    # wavefront runs one lane per pixel; smaller images replicate pixels
    # into sample groups up to this width.
    "gpu": Route(forward="persistent", rays_per_pass=1 << 20, lanes=1 << 20),
}


def route(platform: str | None = None, sd=None) -> Route:
    """The route for ``platform`` (default: JAX's default backend), with
    the lane count capped for exact per-ray-time scenes when ``sd`` is
    given. Raises ValueError for a platform with no route."""
    platform = platform or jax.default_backend()
    if platform not in ROUTES:
        raise ValueError(
            f"no route for platform {platform!r}: crucible_tpu runs on "
            f"{sorted(ROUTES)} ('cpu' is for tests)"
        )
    r = ROUTES[platform]
    if sd is not None and sd.motion_exact:
        r = dataclasses.replace(r, lanes=min(r.lanes, EXACT_MOTION_MAX_LANES))
    return r


def checkout_dir() -> Path:
    """The directory that holds the ``crucible_tpu`` package."""
    return Path(__file__).resolve().parents[2]


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed. Otherwise the cache goes to ``<checkout>/.jax_cache``
    (git-ignored). Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(checkout_dir() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()`` when they are GPUs; raise otherwise.
    Measurement entry points call this instead of falling back to the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found only {devices[0].platform!r} devices"
        )
    return devices
