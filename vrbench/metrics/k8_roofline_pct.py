"""K8's share of its roofline: ``kernels/deint.rows3_mid`` ->
``csrc/rows3_mid*.cu``, the chroma's H upsample, the Dolby Vision convert
and the H resize (``roofline.stage_share``)."""

from .. import roofline

STAGE = "K8"
KERNELS = ("rows3_mid_kernel", "rows3_mid_long_kernel")


def read(ctx):
    return roofline.stage_share(ctx, STAGE, KERNELS)
