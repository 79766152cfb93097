"""The HDR passthrough chain of a 4:2:0 source (the port's K1 x2 + K2 where
the width keeps its size, c7's form; K1 x3 + K2 where it changes):

- ``K1``: the chroma's W pass (its upsample composed with the W resize):
  the two raw chroma planes in, two planes of output width out at 2 bytes;
  and only where the width changes, the luma's W pass likewise;
- ``K2``: the H pass of the three planes (none for a luma whose height
  keeps its size; the chroma's H upsample composed in), the colour matrix,
  the local tone map, the dither and the pack: the raw luma (or its W
  pass's output) and the two 2-byte chroma planes in, the 4-byte surface
  out;
- ``call``: the raw planes in and the surface out.

FLOPs: two a tap of each map's nonzero weights, 18 a pixel for the colour
matrix and its offsets; the PQ curves and the tone map are not counted."""

from __future__ import annotations

from ..reference import scale
from .fused_mid16 import MID, RAW, SURFACE, taps


def axis(config: dict, n_in: int, n_out: int):
    """The (n_in, n_out) map of one axis, None where it keeps its size: the
    upscaling filter up to a 2:1 shrink with ``interpolate_at_50pct``
    (``scale.axis_matrix`` refuses a stronger one)."""
    if n_in == n_out:
        return None
    return scale.axis_matrix(config["settings"]["upscaling"], n_in, n_out)


def stages(config: dict, batch: int) -> dict:
    src, out = config["video_source"], config["output"]
    b, w, h = batch, int(src["width"]), int(src["height"])
    ow, oh = int(out["width"]), int(out["height"])
    wx, wy = axis(config, w, ow), axis(config, h, oh)
    cx, cy = scale.chroma_w(w // 2), scale.chroma_h(h // 2)
    if wx is not None:
        cx = cx @ wx
    if wy is not None:
        cy = cy @ wy
    ch, cw = h // 2, w // 2
    luma_raw = b * h * w * RAW
    chroma_raw = 2 * b * ch * cw * RAW
    chroma_w = 2 * b * ch * ow * MID
    surface = b * oh * ow * SURFACE
    k1_bytes, k1_flops = chroma_raw + chroma_w, 2 * 2 * b * ch * taps(cx)
    luma_in = luma_raw
    if wx is not None:
        luma_in = b * h * ow * MID
        k1_bytes += luma_raw + luma_in
        k1_flops += 2 * b * h * taps(wx)
    h_taps = 2 * taps(cy) + (0 if wy is None else taps(wy))
    k2 = (luma_in + chroma_w + surface,
          2 * b * ow * h_taps + 18 * b * oh * ow)
    return {"K1": (k1_bytes, k1_flops), "K2": k2,
            "call": (luma_raw + chroma_raw + surface, k1_flops + k2[1])}
