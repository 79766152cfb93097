"""Mean host milliseconds inside a call into the port's entry (the
adapter's packing of a new scene's curves included), over the traced
window's calls, on the host's clock.  The profiler is on in that run, so
the number includes its cost on every operation the call runs."""


def read(ctx):
    calls = ctx.window.calls
    if not calls:
        return None
    return 1e3 * sum(c.return_s - c.submit_s for c in calls) / len(calls)
