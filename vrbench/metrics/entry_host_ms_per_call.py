"""Mean host milliseconds of the window's root ``vrt.call`` spans: a call
into the port's entry timed from inside it, with the profiler on (the
adapter's packing of a scene's curves, before the call, left out)."""

from .. import program


def read(ctx):
    p = program.of(ctx)
    roots = p.roots if p is not None else []
    if not roots:
        return None
    return 1e3 * sum(p.seconds(i) for i in roots) / len(roots)
