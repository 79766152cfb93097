"""K9's share of its roofline: ``kernels/deint.cols3_tail`` ->
``csrc/cols3_tail*.cu``, the W resize, tail, dither and pack
(``roofline.stage_share``)."""

from .. import roofline

STAGE = "K9"
KERNELS = ("cols3_tail_kernel", "cols3_tail_long_kernel")


def read(ctx):
    return roofline.stage_share(ctx, STAGE, KERNELS)
