"""Scatter-free differentiable row fetches for the replay gradient path.

The VJP of ``jnp.take`` is a scatter-add. Expressing the fetch as a one-hot
matmul makes reverse-mode AD transpose it into ``onehot.T @ g`` — another
matmul, deterministic and free of atomics. Whether a plain ``jnp.take``
with its atomic scatter-add backward is faster on the GPU is not measured
yet.

Forward is exact: each output row of ``onehot @ table`` is a sum with
exactly one non-zero f32 term. precision=HIGHEST keeps the product in full
f32 (no TF32, no bf16 passes), which geometry columns need.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Materialized one-hot cap. The one-hot is (chunk, N) f32 live only inside
# one bounce's (rematerialized) step, so a generous cap just avoids
# pathological memory spikes at very large R * N.
_MAX_ONEHOT_BYTES = 1 << 28  # 256 MB


def take_rows_mm(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``jnp.take(table, idx, axis=0)`` as a one-hot matmul.

    Args:
      table: (N, C) float32 attribute table (differentiable).
      idx: (R,) int32 row indices in [0, N).

    Returns:
      (R, C) fetched rows. d(out)/d(table) flows through the matmul, so the
      backward pass is a (N, R) x (R, C) contraction — no scatter.
    """
    r = idx.shape[0]
    n = table.shape[0]
    chunk = max(8, min(r, _MAX_ONEHOT_BYTES // (4 * max(n, 1))))
    cols = jnp.arange(n, dtype=jnp.int32)[None, :]
    outs = []
    for lo in range(0, r, chunk):
        ids = jax.lax.dynamic_slice_in_dim(idx, lo, min(chunk, r - lo))
        onehot = (ids[:, None] == cols).astype(table.dtype)
        outs.append(
            jnp.dot(onehot, table, precision=jax.lax.Precision.HIGHEST)
        )
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
