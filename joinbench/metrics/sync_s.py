"""Mean ``JoinStats.t_sync`` a join over the window: host seconds of the
fused chain's end (the device's unfinished tail, the one gather and the
float64 host re-check of borderline rows)."""


def read(ctx):
    return sum(st["t_sync"] for st in ctx.stats) / len(ctx.stats)
