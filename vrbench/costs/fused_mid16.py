"""The fused HDR10 chain of a 4:2:0 source (the port's K1 x3 + K2):

- ``K1``: the W pass of every plane, the chroma upsampled along W on the
  way (the composite of the chroma's W upsample and the W resize): the
  raw uint16 planes in, the three W-resized planes out at 2 bytes;
- ``K2``: the H pass of the three planes (the chroma's H upsample
  composed in), the colour matrix, the tail, the dither and the pack: the
  three 2-byte planes in, the 4-byte surface out;
- ``call``: the whole call, the raw planes in and the surface out.

FLOPs: two a tap of each map's nonzero weights, 18 a pixel for the colour
matrix and its offsets."""

from __future__ import annotations

import numpy as np

from ..reference import scale

MID = 2      # bytes of an intermediate value (the port's mid16)
RAW = 2      # bytes of a P010 code
SURFACE = 4  # bytes of an R10G10B10A2 word


def taps(mat: np.ndarray) -> int:
    """Nonzero weights of an (n_in, n_out) map: the taps of one line."""
    return int(np.count_nonzero(mat))


def shape(config: dict, batch: int) -> tuple:
    src, out = config["video_source"], config["output"]
    name = config["settings"]["upscaling"]
    return (batch, int(src["width"]), int(src["height"]), int(out["width"]),
            int(out["height"]), name)


def stages(config: dict, batch: int) -> dict:
    b, w, h, ow, oh, name = shape(config, batch)
    wx, wy = scale.axis_matrix(name, w, ow), scale.axis_matrix(name, h, oh)
    cx = scale.chroma_w(w // 2) @ wx
    cy = scale.chroma_h(h // 2) @ wy
    raw = b * (h * w + 2 * (h // 2) * (w // 2)) * RAW
    mid = b * (h * ow + 2 * (h // 2) * ow) * MID
    surface = b * oh * ow * SURFACE
    k1 = (raw + mid, 2 * b * (h * taps(wx) + 2 * (h // 2) * taps(cx)))
    k2 = (mid + surface,
          2 * b * ow * (taps(wy) + 2 * taps(cy)) + 18 * b * oh * ow)
    return {"K1": k1, "K2": k2, "call": (raw + surface, k1[1] + k2[1])}
