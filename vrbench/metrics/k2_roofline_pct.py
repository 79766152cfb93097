"""K2's share of its roofline: ``kernels/resize.rows3_tail`` ->
``csrc/rows3_tail*.cu``, the H pass, colour matrix, tail, dither and pack
(``roofline.stage_share``)."""

from .. import roofline

STAGE = "K2"
KERNELS = ("rows3_tail_kernel", "rows3_tail_long_kernel")


def read(ctx):
    return roofline.stage_share(ctx, STAGE, KERNELS)
