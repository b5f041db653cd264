"""Mean ``JoinStats.t_refine`` a join over the window: host seconds of the
fused chain's refine stage (the compaction and the dispatch of every
chunk of the float64 refine, waiting when the launch queue is full)."""


def read(ctx):
    return sum(st["t_refine"] for st in ctx.stats) / len(ctx.stats)
