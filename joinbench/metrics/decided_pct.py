"""Percent of the candidates the APRIL filter decides (TRUE_HIT or
TRUE_NEG) without geometry, from ``JoinStats`` counts over the window."""


def read(ctx):
    shares = [(st["n_true_hits"] + st["n_true_negs"]) / st["n_candidates"]
              for st in ctx.stats if st["n_candidates"]]
    return 100.0 * sum(shares) / len(shares) if shares else None
