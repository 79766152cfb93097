"""Percent of the roofline that the whole call reaches: the least time of
the call's bytes and FLOPs (``costs/<chain>.py``'s ``call``: the raw planes
in, the surface out) over the device's busy time per traced call."""

from .. import roofline


def read(ctx):
    if ctx.trace is None or "call" not in ctx.costs or not ctx.trace.calls:
        return None
    busy = ctx.trace.busy_s
    if busy <= 0.0:
        return None
    nbytes, flops = ctx.costs["call"]
    return 100.0 * ctx.trace.calls * roofline.least_seconds(nbytes, flops) \
        / busy
