"""K6's share of its roofline: ``kernels/jinc2.jinc2_convert_fused`` ->
``csrc/jinc2_convert.cu``, the chroma upsample, the colour matrix, the
one-pass Jinc2 with anti-ringing, the dither and the pack
(``roofline.stage_share`` over ``costs/jinc2_k6.py``'s K6)."""

from .. import roofline

STAGE = "K6"
KERNELS = ("jinc2_convert_kernel",)


def read(ctx):
    return roofline.stage_share(ctx, STAGE, KERNELS)
