"""Observability: jax.profiler traces + throughput counters.

SURVEY.md §5 — the reference has no tracing/profiling (criterion bench
only); here jax.profiler traces and rays/sec counters.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Optional

import jax


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Wrap a render in a jax.profiler trace (viewable in TensorBoard /
    Perfetto). No-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


@dataclass
class RenderStats:
    """Accumulates per-pass throughput; printable as a JSON line."""

    rays: int = 0
    seconds: float = 0.0
    passes: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, rays: int) -> None:
        self.seconds += time.time() - self._t0
        self.rays += rays
        self.passes += 1

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def json(self) -> str:
        return json.dumps(
            dict(
                rays=self.rays,
                seconds=round(self.seconds, 3),
                passes=self.passes,
                rays_per_sec=round(self.rays_per_sec, 1),
            )
        )
