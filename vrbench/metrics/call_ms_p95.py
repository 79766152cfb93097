"""The 95th percentile, over every call completed in the window, of the
time from its slot's freeing to the end of its work on the device
(``loop``): the wait of a request issued the moment a slot frees."""

from .. import stats


def read(ctx):
    done = ctx.window.completed
    if not done:
        return None
    return 1e3 * stats.percentile([c.done_s - c.free_s for c in done], 95)
