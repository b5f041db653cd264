"""Seconds of the ``pip`` stage of the plan's APRIL builds of both
layers (``BUILD_STAGES``, as the window's first join reports them in
``JoinStats.extra["build_stages"]``); nothing where the program does not
report them. On one H100 it read 0.58 to 12.80 s on the same layers from
run to run, for a cause not yet found (neither a cold start nor host
contention gives it), so it cannot yet tell a change from that swing."""


def read(ctx):
    if not ctx.stats:
        return None
    return ctx.stats[0].get("extra", {}).get("build_stages", {}).get("pip")
