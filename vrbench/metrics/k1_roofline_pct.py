"""K1's share of its roofline: ``kernels/resize.banded_resize_last_axis``
-> ``csrc/banded_resize.cu``, the W pass (``roofline.stage_share``)."""

from .. import roofline

STAGE = "K1"
KERNELS = ("banded_resize_kernel",)


def read(ctx):
    return roofline.stage_share(ctx, STAGE, KERNELS)
