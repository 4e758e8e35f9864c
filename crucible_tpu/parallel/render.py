"""Multi-device render driver: one block of pixels per device of the mesh.

User-facing counterpart of the test/driver-contract sharding (SURVEY.md
§2.7): the flat pixel grid is cut into one contiguous block per device, the
scene/BVH/camera replicate into every device's memory, and each device runs
the platform route's still program (``render.render_image_data`` with
``pixel_ids``: the persistent wavefront on a GPU, lockstep tiles on the
CPU) over its block; the framebuffer gathers on the host. Each pixel goes
through the same one-device arithmetic as in ``render.render_image``, so
the image is bit-identical to a one-device render: the RNG is a pure
counter hash (utils/rng.py), and no per-device-count compile can reorder
the arithmetic. (An SPMD program over n GPUs is compiled apart from the
one-device program, and the two contract multiply-adds into FMAs
differently: ~1% of pixels moved by ~1e-6 on four H100s.)

The devices must be addressable by this process (one host).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from crucible_tpu.models import render
from crucible_tpu.models.scene import Scene
from crucible_tpu.parallel import mesh as mesh_mod


def render_image_sharded(
    scene: Scene,
    mesh=None,
    samples: int | None = None,
    max_depth: int | None = None,
    seed: int | None = None,
    mode: str = "auto",
) -> np.ndarray:
    """Render with one pixel block per device of ``mesh`` (default: every
    local device), each device fed by its own host thread so the devices
    render concurrently. ``mode`` as in ``render.render_image_data``.
    Returns (H, W, 3) float32, bit-identical to ``render.render_image``
    on one device."""
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    devices = list(mesh.devices.flat)
    sd = scene.build()
    cam = scene.scene_cam
    cp = cam.params()
    w, h = cam.image_width, cam.image_height
    spp = samples if samples is not None else cam.samples
    depth = max_depth if max_depth is not None else cam.max_depth
    seed = seed if seed is not None else scene.seed

    num_pixels = w * h
    block = -(-num_pixels // len(devices))
    # The last block repeats the last pixel id; its copies are dropped.
    pixel_ids = np.minimum(
        np.arange(len(devices) * block, dtype=np.uint32), num_pixels - 1
    ).reshape(len(devices), block)

    def render_on(i):
        # A thread per device: the tiled route waits on its device at every
        # tile, and a thread that waits dispatches nothing.
        dev = devices[i]
        sd_d, cp_d = jax.device_put((sd, cp), dev)
        return render.render_image_data(
            sd_d, cp_d, w, h, spp, depth, seed, mode=mode, pixel_ids=pixel_ids[i]
        )

    with ThreadPoolExecutor(len(devices)) as pool:
        blocks = list(pool.map(render_on, range(len(devices))))
    return np.concatenate(blocks)[:num_pixels].reshape(h, w, 3)
