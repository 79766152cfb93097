"""Output frames of the calls completed in the window over the window's
seconds."""


def read(ctx):
    return ctx.cell.batch * len(ctx.window.completed) / ctx.window.seconds
