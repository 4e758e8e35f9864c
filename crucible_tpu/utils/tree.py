"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree children unless declared with :func:`static_field`, which
marks them as hashable metadata that ``jit`` specializes on.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A dataclass field that rides in the pytree's static metadata."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def pytree_dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass, register it with
    ``jax.tree_util.register_dataclass`` and give it ``.replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)
