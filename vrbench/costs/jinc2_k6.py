"""The Jinc2 upscale chain of a 4:2:0 source with a dither-only tail (the
port's K6 alone: ``kernels/jinc2.jinc2_convert_fused``):

- ``K6``: the chroma upsample, the colour matrix, the one-pass 2D Jinc2
  with its anti-ringing, the dither and the pack: the three raw planes in,
  the 4-byte surface out, nothing in between through device memory;
- ``call``: the same work, K6 being the call.

FLOPs: two a tap for the Jinc2's 16 taps on each of 3 channels of every
output (96 an output); the chroma upsample's taps, two a tap, counted once
a source pixel (a tile's window built again where windows overlap is not
counted); 18 a source pixel for the colour matrix and its offsets.  The
weights (read from a table), their normalisation, the anti-ringing and the
dither are not counted (``roofline.py``'s rule)."""

from __future__ import annotations

from ..reference import scale
from .fused_mid16 import taps

RAW = 1      # bytes of an NV12 code
SURFACE = 4  # bytes of an RGBA8 word
JINC2_TAPS = 16


def stages(config: dict, batch: int) -> dict:
    src, out = config["video_source"], config["output"]
    b, w, h = batch, int(src["width"]), int(src["height"])
    ow, oh = int(out["width"]), int(out["height"])
    ch, cw = h // 2, w // 2
    raw = b * (h * w + 2 * ch * cw) * RAW
    surface = b * oh * ow * SURFACE
    chroma = 2 * b * 2 * (ch * taps(scale.chroma_w(cw))
                          + w * taps(scale.chroma_h(ch)))
    k6 = (raw + surface,
          2 * JINC2_TAPS * 3 * b * oh * ow + chroma + 18 * b * h * w)
    return {"K6": k6, "call": k6}
