"""Still-image export — SaveToBMP / SaveToImage analogue
(Source/Helper.h:214-216, Source/Helper.cpp screenshot writers); a copy of
``videorenderer_tpu.io.image``.

BMP by a dependency-free writer (the reference's own path is a hand-rolled
BMP writer too); PNG/JPEG via Pillow when it is installed.
"""

from __future__ import annotations

import struct

import numpy as np


def save_bmp(path: str, rgb: np.ndarray) -> None:
    """Write a 24-bit BMP from (H, W, 3) uint8 RGB (hand-rolled, matching
    SaveToBMP's DIB layout: bottom-up rows, BGR byte order, 4-byte aligned
    rows)."""
    h, w, _ = rgb.shape
    row = w * 3
    pad = (4 - row % 4) % 4
    img_size = (row + pad) * h
    header = struct.pack("<2sIHHI", b"BM", 54 + img_size, 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size,
                      2835, 2835, 0, 0)
    bgr = rgb[::-1, :, ::-1]  # bottom-up, BGR
    with open(path, "wb") as f:
        f.write(header)
        f.write(dib)
        if pad:
            padding = b"\x00" * pad
            for r in bgr:
                f.write(r.tobytes())
                f.write(padding)
        else:
            f.write(np.ascontiguousarray(bgr).tobytes())


def save_image(path: str, rgb: np.ndarray) -> None:
    """Write PNG/JPEG/BMP by extension (SaveToImage analogue); ``rgb`` is
    (H, W, 3) uint8, or float in [0, 1] (rounded to 8 bits)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "bmp":
        save_bmp(path, rgb)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"Pillow unavailable for .{ext} export") from e
    Image.fromarray(rgb, "RGB").save(path)
