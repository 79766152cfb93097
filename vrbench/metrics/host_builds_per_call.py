"""Host state a call rebuilds: the ``vrt.build.*`` spans (a ``mid_stage``,
an ``epilogue``, a table's ``upload``, a map's ``windows``) inside the
window's root calls, over the root calls."""

from .. import program


def read(ctx):
    p = program.of(ctx)
    roots = p.roots if p is not None else []
    if not roots:
        return None
    return len(p.in_roots("vrt.build.")) / len(roots)
