"""The one-intermediate Dolby Vision chain of a 4:2:0 source (the port's
K1 x2 + K8 + K9):

- ``K1``: the chroma's W upsample to the source width: the two raw chroma
  planes in, two planes of source width out at 2 bytes;
- ``K8``: the chroma's H upsample, the reshape, the RPU matrix and the LMS
  step at source resolution, then the H resize of R, G and B: the raw luma
  and the two chroma planes in, three planes of output height and source
  width out at 2 bytes;
- ``K9``: the W resize of the three planes, the PQ -> SDR tail, the dither
  and the pack: the three planes in, the 4-byte surface out;
- ``call``: the raw planes in and the surface out.

FLOPs: two a tap of each map's nonzero weights, 18 a source pixel for the
RPU matrix and its offsets; the reshape's curves, the LMS step's PQ curves
and the tail are not counted."""

from __future__ import annotations

from ..reference import scale
from .fused_mid16 import MID, RAW, SURFACE, shape, taps


def stages(config: dict, batch: int) -> dict:
    b, w, h, ow, oh, name = shape(config, batch)
    wx, wy = scale.axis_matrix(name, w, ow), scale.axis_matrix(name, h, oh)
    ch, cw = h // 2, w // 2
    luma = b * h * w * RAW
    chroma_raw = 2 * b * ch * cw * RAW
    chroma_w = 2 * b * ch * w * MID
    rows = 3 * b * oh * w * MID
    surface = b * oh * ow * SURFACE
    k1 = (chroma_raw + chroma_w, 2 * 2 * b * ch * taps(scale.chroma_w(cw)))
    k8 = (luma + chroma_w + rows,
          2 * 2 * b * w * taps(scale.chroma_h(ch)) + 18 * b * h * w
          + 3 * 2 * b * w * taps(wy))
    k9 = (rows + surface, 3 * 2 * b * oh * taps(wx))
    return {"K1": k1, "K8": k8, "K9": k9,
            "call": (luma + chroma_raw + surface, k1[1] + k8[1] + k9[1])}
