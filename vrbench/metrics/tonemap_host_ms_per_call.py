"""Host milliseconds a call spends making the local tone map's scalars
from its runtime HDR10 values: the ``vrt.tonemap_scalars`` spans
(``pipeline._tonemap_scalars``, inside the epilogue a call with ``rt``
rebuilds) inside the window's root calls, over the root calls."""

from .. import program

SPAN = "vrt.tonemap_scalars"


def read(ctx):
    p = program.of(ctx)
    roots = p.roots if p is not None else []
    if not roots:
        return None
    return 1e3 * sum(p.seconds(i) for i in p.in_roots(SPAN)) / len(roots)
