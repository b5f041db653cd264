"""Percent of a traced stretch of whole joins in which the device ran no
kernel, copy or set (the union of their intervals, streams counted
once)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
