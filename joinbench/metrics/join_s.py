"""Seconds a whole-layer join takes: the window's wall time over the joins
it completed, each from its first dispatch to its pairs on the host."""


def read(ctx):
    return ctx.window_s / ctx.joins
