"""Seconds from the harness's start to the window's: imports, the device,
the kernels' build or load, the inputs, the system under test and the
warm-up of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
