"""Math core: angles, vectors, intervals, color pipeline, counter-based RNG.

Batched analogue of the reference's ``src/utils.rs`` (913 LoC): instead of
scalar ``Vec3``/``Color`` structs, everything here operates on batched
``jnp`` arrays whose last axis is the component axis.
"""

from crucible_tpu.utils.angles import Degrees, Radians  # noqa: F401
from crucible_tpu.utils import vec  # noqa: F401
from crucible_tpu.utils import interval  # noqa: F401
from crucible_tpu.utils import color  # noqa: F401
from crucible_tpu.utils import rng  # noqa: F401
