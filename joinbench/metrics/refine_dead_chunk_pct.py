"""Percent of the fused refine's dead chunks that it walked over the
window. A chunk of the frame (``refine_chunk_rows`` rows, the frame
``n_frame`` rows) is dead when it holds no INDECISIVE row; the refine
walked ``refine_chunks`` of them, ``refine_chunks_live`` live
(``JoinStats.extra``). A refine that walks every chunk reads 100 however
many rows the filter decides, one that skips the dead chunks 0; nothing
where the program does not count them."""


def read(ctx):
    walked = dead = 0
    for st in ctx.stats:
        x = st.get("extra", {})
        C = x.get("refine_chunk_rows")
        if C is None:
            return None
        if C:
            live = x["refine_chunks_live"]
            walked += x["refine_chunks"] - live
            dead += -(-x["n_frame"] // C) - live
    if not ctx.stats:
        return None
    return 100.0 * walked / dead if dead else 0.0
