"""Seconds of the ``dda`` stage of the plan's APRIL builds of both
layers (``BUILD_STAGES``, as the window's first join reports them in
``JoinStats.extra["build_stages"]``); nothing where the program does not
report them."""


def read(ctx):
    if not ctx.stats:
        return None
    return ctx.stats[0].get("extra", {}).get("build_stages", {}).get("dda")
