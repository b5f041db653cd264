"""Seconds of the plan's APRIL builds of both layers (``JoinPlan.build``
with the torch build backend), ended by a device synchronize."""


def read(ctx):
    return ctx.build_s
