"""Mean ``JoinStats.t_mbr`` a join over the window: host seconds of the
fused chain's candidates stage (the grid hash of the MBRs on the host and
the frame's upload)."""


def read(ctx):
    return sum(st["t_mbr"] for st in ctx.stats) / len(ctx.stats)
