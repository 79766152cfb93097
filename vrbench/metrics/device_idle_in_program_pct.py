"""Percent of the traced window in which no operation ran on the device
while the host was inside one of the program's spans: the part of
``device_idle_pct`` the device spent waiting on the program's host work,
with the spans moved onto the trace by ``program.offset``."""

from .. import program


def read(ctx):
    p = program.of(ctx)
    if p is None or ctx.trace.window_s <= 0.0:
        return None
    window = ctx.trace.window_s
    inside = [(max(a, 0.0), min(b, window))
              for i, (a, b) in p.at.items() if p.spans[i][2] is None]
    busy = [(a, b) for _, a, b in ctx.trace.device_ops]
    return 100.0 * program.idle_within(inside, busy) / window
