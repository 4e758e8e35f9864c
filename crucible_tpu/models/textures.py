"""SoA texture table: solid colors, 3-D checker, nearest-neighbor images.

Reference: ``src/textures/`` — ``Textures`` enum with
``value(u, v, p) -> Color`` (src/textures/mod.rs:12-31). Here a texture is a
row in a table; evaluation is vectorized over the wavefront and the enum
dispatch becomes masked selects.

Checker composition: the reference lets checker children be arbitrary
``Arc<Textures>`` (src/textures/checker_texture.rs:12-36). Checker children
here may be any texture including other checkers: the table records the
scene's maximum nesting depth (static) and evaluation resolves that many
indirection levels with a fixed unroll — each level applies ITS OWN
inv_scale parity before stepping into the chosen child. The replay's
winner-row table bakes one level of checker colors, so deeper nesting
evaluates through :func:`value` there too.

Texel gradients: image lookups are ``jnp.take`` gathers, so radiance is
differentiable w.r.t. every texel and every solid color in the table.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from crucible_tpu.utils.tree import pytree_dataclass, static_field

SOLID = 0
CHECKER = 1
IMAGE = 2


@pytree_dataclass
class TextureTable:
    """Parallel arrays over texture ids (T rows) + static tuple of images."""

    kind: jnp.ndarray  # (T,) int32 in {SOLID, CHECKER, IMAGE}
    color: jnp.ndarray  # (T, 3) solid albedo
    inv_scale: jnp.ndarray  # (T,) checker 1/scale (src/textures/checker_texture.rs:22)
    even: jnp.ndarray  # (T,) int32 child id (checker)
    odd: jnp.ndarray  # (T,) int32 child id (checker)
    image_id: jnp.ndarray  # (T,) int32 index into `images`
    images: Tuple[jnp.ndarray, ...] = ()  # each (H, W, 3) f32
    # Deepest checker-of-checker chain in the table (static: sizes the
    # resolution unroll in `value`). 1 = plain checkers of leaves.
    max_nest: int = static_field(1)


def image_lookup(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor lookup with clamp + v flip.

    Reference: src/textures/image_texture.rs:23-31 — clamp u,v to [0,1],
    v := 1 - v, i = (u*W) as usize, j = (v*H) as usize, then the accessor
    clamps to the last texel (src/asset_loader/img_loader.rs:69-77).
    """
    h, w = img.shape[0], img.shape[1]
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    i = jnp.clip(jnp.floor(uu * w).astype(jnp.int32), 0, w - 1)
    j = jnp.clip(jnp.floor(vv * h).astype(jnp.int32), 0, h - 1)
    flat = img.reshape(-1, 3)
    return jnp.take(flat, j * w + i, axis=0)


def _leaf_value(tex: TextureTable, tid, u, v):
    """Evaluate assuming every selected row is a leaf (solid or image)."""
    out = jnp.take(tex.color, tid, axis=0)  # solid default
    kind = jnp.take(tex.kind, tid, axis=0)
    img_of = jnp.take(tex.image_id, tid, axis=0)
    for k, img in enumerate(tex.images):  # static unroll over scene images
        mask = (kind == IMAGE) & (img_of == k)
        out = jnp.where(mask[:, None], image_lookup(img, u, v), out)
    return out


def value(tex: TextureTable, tid, u, v, p) -> jnp.ndarray:
    """Texture color for a wavefront: tid (R,), u/v (R,), p (R,3) -> (R,3).

    Checker parity: floor(p * inv_scale) summed over axes, even -> `even`
    child (src/textures/checker_texture.rs:39-52). Nested checkers resolve
    through a static unroll of ``max_nest`` levels — the iterative form of
    the reference's recursion into ``Arc<Textures>`` children.
    """
    resolved = jnp.asarray(tid)
    for _ in range(tex.max_nest):
        kind = jnp.take(tex.kind, resolved, axis=0)
        inv_scale = jnp.take(tex.inv_scale, resolved, axis=0)
        xyz = jnp.floor(inv_scale[:, None] * p).astype(jnp.int32)
        is_even = (xyz[:, 0] + xyz[:, 1] + xyz[:, 2]) % 2 == 0
        child = jnp.where(
            is_even,
            jnp.take(tex.even, resolved, axis=0),
            jnp.take(tex.odd, resolved, axis=0),
        )
        resolved = jnp.where(kind == CHECKER, child, resolved)
    return _leaf_value(tex, resolved, u, v)
