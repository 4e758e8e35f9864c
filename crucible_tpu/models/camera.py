"""Camera: viewport math, defocus, stochastic shutter, batched ray generation.

Mirrors the reference camera (src/camera/mod.rs:66-263 and
src/camera/rendering_compute.rs:5-110) as a host-side settings object
(:class:`Camera`) plus a jit-ready parameter pytree (:class:`CameraParams`)
and a vectorized ray generator. Camera parameters are pytree leaves, so
radiance is differentiable w.r.t. look-from/at, vfov, defocus and focus
distance.

Deviation: the reference's freshly-constructed camera uses focal length 1.0
for the viewport until any setter recomputes it from ``focus_dist``
(src/camera/mod.rs:117-121 vs rendering_compute.rs:5-11); every demo calls
``set_vfov``, so we always use ``focus_dist`` — the post-setter behavior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import jax.numpy as jnp
from crucible_tpu.utils.tree import pytree_dataclass, static_field

from crucible_tpu.ops import sampling
from crucible_tpu.utils import rng as crng
from crucible_tpu.utils import vec


@pytree_dataclass
class CameraParams:
    """Differentiable camera parameters (all jnp scalars / 3-vectors).

    Animated cameras carry shutter-motion deltas: the camera position at a
    ray's stochastic shutter fraction w in [0,1) is
    ``look_from + w * look_from_d`` (piecewise-linear within the shutter
    window — exact for the timeline's LERP/NERP tracks unless a keyframe
    falls inside one frame's shutter; see models/timeline.py).
    """

    look_from: jnp.ndarray  # (3,) at shutter open
    look_at: jnp.ndarray  # (3,)
    vup: jnp.ndarray  # (3,)
    vfov_rad: jnp.ndarray  # ()
    defocus_angle_rad: jnp.ndarray  # ()
    focus_dist: jnp.ndarray  # ()
    frame_time: jnp.ndarray  # () = frame / frame_rate
    shutter_length: jnp.ndarray  # () = (shutter_angle/360) / frame_rate
    look_from_d: jnp.ndarray = None  # (3,) shutter-close minus shutter-open
    look_at_d: jnp.ndarray = None  # (3,)
    # Exact per-ray-time camera tracks (set only when a camera keyframe lands
    # inside the shutter window — the linear lerp above then deviates from
    # per-ray timeline evaluation; models/timeline.py).
    from_tr_t0: jnp.ndarray = None  # (K,)
    from_tr_t1: jnp.ndarray = None
    from_tr_delta: jnp.ndarray = None  # (K, 3)
    from_tr_init: jnp.ndarray = None  # (3,)
    at_tr_t0: jnp.ndarray = None
    at_tr_t1: jnp.ndarray = None
    at_tr_delta: jnp.ndarray = None
    at_tr_init: jnp.ndarray = None
    animated: bool = static_field(False)
    motion_exact: bool = static_field(False)


def generate_rays(
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids: jnp.ndarray,
    sample_ids: jnp.ndarray,
    seed,
):
    """Generate one primary ray per (pixel, sample) pair.

    Follows cast_ray (src/camera/ray_casting.rs:64-108): stochastic shutter
    time, [-0.5,0.5)^2 pixel jitter, optional defocus-disk origin, direction
    = pixel_pos - origin (unnormalized, as in the reference).

    Args:
      pixel_ids: (R,) int32 flat pixel index j*width + i.
      sample_ids: (R,) int32 sample index within the pixel.
      seed: uint32 render seed.

    Returns: (origins (R,3), directions (R,3), times (R,))
    """
    i = (pixel_ids % width).astype(jnp.float32)
    j = (pixel_ids // width).astype(jnp.float32)

    # One PCG4D evaluation covers pixel jitter (lanes 0-1) and the defocus
    # disk (lanes 2-3) — u32 hashing is expensive on the VPU, so the camera
    # costs a single hash per ray. The shutter-time hash is separate (its
    # own stream) and dead-code-eliminated by XLA for static scenes.
    ux, uy, ud1, ud2 = crng.uniform4(
        pixel_ids, sample_ids, crng.STREAM_PIXEL_JITTER, seed
    )
    u_t = crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)

    times = cp.frame_time + u_t * cp.shutter_length

    # Camera basis (rendering_compute.rs:76-92). For timeline-animated
    # cameras (motion blur) the basis is re-derived PER RAY at the ray's
    # shutter fraction — the vectorized form of the reference recomputing
    # u/v/w per call at the ray time.
    if cp.animated and cp.motion_exact:
        # Exact piecewise-linear track evaluation at the ray's absolute time
        # (camera keyframe inside the shutter window).
        from crucible_tpu.models.timeline import eval_translate

        t_ray = times  # frame_time + u_t * shutter_length (absolute)
        lf = eval_translate(
            cp.from_tr_t0, cp.from_tr_t1, cp.from_tr_delta, cp.from_tr_init, t_ray
        )  # (R, 3)
        la = eval_translate(
            cp.at_tr_t0, cp.at_tr_t1, cp.at_tr_delta, cp.at_tr_init, t_ray
        )
    elif cp.animated:
        w01 = u_t[:, None]  # (R, 1)
        lf = cp.look_from[None, :] + w01 * cp.look_from_d[None, :]  # (R, 3)
        la = cp.look_at[None, :] + w01 * cp.look_at_d[None, :]
    else:
        lf = cp.look_from  # (3,)
        la = cp.look_at
    w = vec.unit(lf - la, eps=1e-12)
    u = vec.unit(jnp.cross(jnp.broadcast_to(cp.vup, w.shape), w), eps=1e-12)
    v = jnp.cross(w, u)

    h = jnp.tan(cp.vfov_rad / 2.0)
    viewport_h = 2.0 * h * cp.focus_dist
    viewport_w = viewport_h * (width / height)

    viewport_u = viewport_w * u  # horizontal edge, (..., 3)
    viewport_v = viewport_h * (-v)  # vertical edge, image-down
    du = viewport_u / width
    dv = viewport_v / height
    pixel00 = lf - cp.focus_dist * w - 0.5 * (width - 1) * du - 0.5 * (height - 1) * dv

    offset = sampling.square_offset(ux, uy)  # (R, 2)
    pixel_pos = (
        pixel00
        + (i + offset[:, 0])[:, None] * du
        + (j + offset[:, 1])[:, None] * dv
    )

    defocus_radius = cp.focus_dist * jnp.tan(cp.defocus_angle_rad / 2.0)
    disk = sampling.in_unit_disk(ud1, ud2)  # (R, 2)
    defocus_origin = (
        lf
        + (disk[:, 0] * defocus_radius)[:, None] * u
        + (disk[:, 1] * defocus_radius)[:, None] * v
    )
    use_defocus = cp.defocus_angle_rad > 0.0
    origins = jnp.where(use_defocus, defocus_origin, lf)
    origins = jnp.broadcast_to(origins, pixel_pos.shape)
    dirs = pixel_pos - origins
    return origins, dirs, times


@dataclass
class Camera:
    """Host-side camera settings, mirroring the reference's builder setters
    (src/camera/mod.rs:187-263)."""

    aspect_ratio: float = 16.0 / 9.0
    image_width: int = 400
    frame_rate: float = 24.0
    shutter_angle: float = 180.0

    vfov_deg: float = 90.0
    look_from_pt: tuple = (0.0, 0.0, 0.0)
    look_at_pt: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    defocus_angle_deg: float = 0.0
    focus_dist: float = 10.0

    samples: int = 10
    max_depth: int = 10
    frame: int = 0
    # Pixel sampling strategy; "square" is the only variant, matching the
    # reference's SamplingMethod enum (src/camera/mod.rs:60-63).
    sampling_method: str = "square"

    # Filled by the timeline animator for movie scenes (keyframed from/at).
    from_timeline: Optional[object] = field(default=None, repr=False)
    at_timeline: Optional[object] = field(default=None, repr=False)

    @property
    def image_height(self) -> int:
        # Height clamped >= 1 (src/camera/mod.rs:37-38).
        return max(1, int(self.image_width / self.aspect_ratio))

    # --- reference setter surface -----------------------------------------
    def set_samples(self, s: int) -> None:
        assert s > 0, "samples must be positive"
        self.samples = int(s)

    def set_max_depth(self, d: int) -> None:
        self.max_depth = int(d)

    def set_vfov(self, deg: float) -> None:
        self.vfov_deg = float(deg)

    def set_hfov(self, deg: float) -> None:
        """Convert horizontal fov to vertical (src/camera/mod.rs:218-226)."""
        h = math.tan(math.radians(deg) / 2.0)
        v = h * (self.image_height / self.image_width)
        self.vfov_deg = math.degrees(2.0 * math.atan(v))

    def set_defocus_angle(self, deg: float) -> None:
        self.defocus_angle_deg = float(deg)

    def set_focus_dist(self, dist: float) -> None:
        self.focus_dist = float(dist)

    def set_threads(self, _n: int) -> None:
        """Compatibility no-op: parallelism is device-mesh sharding here, not
        host threads (SURVEY.md §2.7)."""

    def look_from(self, p) -> None:
        """Set the camera position; resets any from-animation, like the
        reference's timeline reset (src/camera/mod.rs:187-195)."""
        self.look_from_pt = tuple(float(x) for x in p)
        self.from_timeline = None

    def look_at(self, p) -> None:
        self.look_at_pt = tuple(float(x) for x in p)
        self.at_timeline = None

    def next_frame(self) -> None:
        self.frame += 1

    def get_res(self) -> tuple:
        """(width, height). The reference returns (width, width) by defect
        (src/camera/mod.rs:164-170) — not replicated."""
        return (self.image_width, self.image_height)

    # --- jit-side params ---------------------------------------------------
    def frame_time(self) -> float:
        return self.frame * (1.0 / self.frame_rate)

    def shutter_window(self) -> tuple:
        t_open = self.frame_time()
        return t_open, t_open + (self.shutter_angle / 360.0) / self.frame_rate

    def params(self) -> CameraParams:
        t_open, t_close = self.shutter_window()
        animated = self.from_timeline is not None or self.at_timeline is not None
        if self.from_timeline is not None:
            from_a = self.from_timeline.position_at(t_open)
            from_b = self.from_timeline.position_at(t_close)
        else:
            from_a = from_b = self.look_from_pt
        if self.at_timeline is not None:
            at_a = self.at_timeline.position_at(t_open)
            at_b = self.at_timeline.position_at(t_close)
        else:
            at_a = at_b = self.look_at_pt
        import numpy as np

        # Mid-shutter camera keyframe -> exact per-ray track evaluation
        # (models/timeline.py; see CameraParams.motion_exact).
        exact = False
        track_fields = {}
        if animated:
            for tl in (self.from_timeline, self.at_timeline):
                if tl is None:
                    continue
                b = tl.boundary_times()
                if np.any((b > t_open + 1e-9) & (b < t_close - 1e-9)):
                    exact = True
            if exact:
                from crucible_tpu.models.timeline import TransformTimeline

                for name, tl, init in (
                    ("from", self.from_timeline, self.look_from_pt),
                    ("at", self.at_timeline, self.look_at_pt),
                ):
                    tl = tl or TransformTimeline(init_pos=tuple(init))
                    a0, a1, dl = tl.lower_translate()
                    if len(a0) == 0:  # static target: one zero-delta segment
                        a0 = a1 = np.zeros((1,), np.float32)
                        dl = np.zeros((1, 3), np.float32)
                    track_fields.update(
                        {
                            f"{name}_tr_t0": jnp.asarray(a0),
                            f"{name}_tr_t1": jnp.asarray(a1),
                            f"{name}_tr_delta": jnp.asarray(dl),
                            f"{name}_tr_init": jnp.asarray(
                                tl.init_pos, jnp.float32
                            ),
                        }
                    )

        return CameraParams(
            motion_exact=exact,
            **track_fields,
            look_from=jnp.asarray(from_a, jnp.float32),
            look_at=jnp.asarray(at_a, jnp.float32),
            vup=jnp.asarray(self.vup, jnp.float32),
            vfov_rad=jnp.asarray(math.radians(self.vfov_deg), jnp.float32),
            defocus_angle_rad=jnp.asarray(
                math.radians(self.defocus_angle_deg), jnp.float32
            ),
            focus_dist=jnp.asarray(self.focus_dist, jnp.float32),
            frame_time=jnp.asarray(t_open, jnp.float32),
            shutter_length=jnp.asarray(
                (self.shutter_angle / 360.0) / self.frame_rate, jnp.float32
            ),
            look_from_d=jnp.asarray(np.subtract(from_b, from_a), jnp.float32),
            look_at_d=jnp.asarray(np.subtract(at_b, at_a), jnp.float32),
            animated=animated,
        )
