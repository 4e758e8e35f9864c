"""Device mesh construction and sharding helpers.

Axes:
  - ``dp``: data parallel over pixels/tiles (the dominant axis).
  - ``sp``: sample parallel — samples of one pixel split across chips and
    mean-reduced (SURVEY.md §2.13 "Sample parallelism").

Because the RNG is a pure counter hash of (pixel, sample) (utils/rng.py),
any (dp, sp) factorization draws the SAME samples as one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"
SP_AXIS = "sp"


def make_mesh(
    n_devices: Optional[int] = None,
    sample_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, sp) mesh over the first ``n_devices`` local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    assert n % sample_parallel == 0, "sample_parallel must divide device count"
    arr = np.asarray(devices).reshape(n // sample_parallel, sample_parallel)
    return Mesh(arr, (DP_AXIS, SP_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pixel_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a flat per-pixel axis over dp (sp replicates)."""
    return NamedSharding(mesh, P(DP_AXIS))


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None):
    """Multi-host bring-up via jax.distributed. No-op when running
    single-process. ``coordinator`` is ``host:port`` of process 0; nothing
    discovers it automatically."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
