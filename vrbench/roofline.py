"""Roofline shares: the least time the card could take for the work a
stage does, over the time it took.

The least time is the larger of the stage's bytes over the memory rate and
its FLOPs over the float32 rate outside the tensor cores, at the published
peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit; the run records the card's power limit beside them).  The bytes and
FLOPs are the cell's, from ``costs/<chain>.py``: each input read once, each
output written once, intermediates at the 2 bytes of the port's mid16 form,
an FMA for every tap, the colour matrices' multiply-adds, and no
transcendental counted.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS_S)


def kernel_seconds(ctx, names) -> float:
    """Device seconds of the traced operations named ``names``."""
    return sum(end - start for name, start, end in ctx.trace.device_ops
               if name in names)


def stage_share(ctx, stage: str, names) -> float | None:
    """Percent of the roofline that the kernels ``names`` reach doing
    ``stage`` for every traced call; None where the cell's chain has no
    such stage or the trace holds none of the kernels."""
    if ctx.trace is None or stage not in ctx.costs:
        return None
    seconds = kernel_seconds(ctx, names)
    if seconds <= 0.0:
        return None
    nbytes, flops = ctx.costs[stage]
    return 100.0 * ctx.trace.calls * least_seconds(nbytes, flops) / seconds
