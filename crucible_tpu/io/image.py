"""Image decode (LDR via PIL, HDR via the RGBE codec) and film output
(PPM, and PNG through NumPy + zlib).

Reference analogues: ``RTWImage`` (src/asset_loader/img_loader.rs:8-77 —
decode to rgb8, byte/255 color scale, clamped accessor) and the P3 PPM
formatting in ``Camera::render`` (src/camera/mod.rs:306-311) +
``Color``'s Display impl (src/utils.rs:427-438).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from crucible_tpu.io.assets import build_asset_path
from crucible_tpu.io import hdr as hdr_io


def load_image(filename: str) -> np.ndarray:
    """Load an asset image -> (H, W, 3) float32.

    LDR formats decode to byte/255 in [0,1] with NO gamma linearization,
    matching the reference's RTWImage scaling. ``.hdr`` files decode to full
    float radiance (deviation from the reference's rgb8 crush — see io/hdr.py).
    """
    path = build_asset_path(filename)
    return load_image_path(path)


def load_image_path(path) -> np.ndarray:
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        return hdr_io.read_hdr(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path.name} needs Pillow (PIL), which is not "
            f"installed; .hdr and procedural assets load without it"
        ) from e

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr


def write_ppm(path, img_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3 PPM (reference film format,
    src/camera/mod.rs:285-311)."""
    img_u8 = np.asarray(img_u8, dtype=np.uint8)
    h, w = img_u8.shape[:2]
    flat = img_u8.reshape(-1, 3)
    # One "r g b" triple per line, like the reference's Display for Color.
    body = "\n".join(f"{r} {g} {b}" for r, g, b in flat)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n{body}\n")


def read_ppm(path) -> np.ndarray:
    """Read an ASCII P3 PPM -> (H, W, 3) uint8 (for golden-image tests)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3", "only ASCII P3 supported"
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    assert maxval == 255
    pix = np.array(tokens[4 : 4 + 3 * w * h], dtype=np.int64)
    return pix.reshape(h, w, 3).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path, img_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an 8-bit RGB PNG (filter type 0 on every
    scanline, zlib-compressed IDAT) — no imaging library needed."""
    img = np.ascontiguousarray(np.asarray(img_u8, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_image(path, img_u8: np.ndarray) -> None:
    """Dispatch on extension: .ppm -> P3 text, anything else -> PNG."""
    path = Path(path)
    if path.suffix.lower() == ".ppm":
        write_ppm(path, img_u8)
    else:
        write_png(path, img_u8)
