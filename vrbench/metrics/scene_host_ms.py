"""Mean host milliseconds of packing a new scene's curves: the window's
``vrt.pack_curves`` spans (``fn.pack_curves``, once a scene, before the
call that takes them)."""

from .. import program


def read(ctx):
    p = program.of(ctx)
    packs = p.named("vrt.pack_curves") if p is not None else []
    if not packs:
        return None
    return 1e3 * sum(p.seconds(i) for i in packs) / len(packs)
