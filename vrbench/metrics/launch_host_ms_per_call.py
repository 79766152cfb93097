"""Host milliseconds a call spends in the kernel wrappers: the summed
``vrt.kernel.*`` spans inside the window's root calls (a wrapper called
inside another counted once, in the outer), over the root calls.  What is
left of ``entry_host_ms_per_call`` is the entry's own host work."""

from .. import program

KERNEL = "vrt.kernel."


def read(ctx):
    p = program.of(ctx)
    roots = p.roots if p is not None else []
    if not roots:
        return None
    outer = [i for i in p.in_roots(KERNEL)
             if not p.spans[p.spans[i][2]][0].startswith(KERNEL)]
    return 1e3 * sum(p.seconds(i) for i in outer) / len(roots)
