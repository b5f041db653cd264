"""Percent of HBM's byte bound that the APRIL trichotomy kernel (B1,
``april_trichotomy_kernel``) reaches over a traced stretch of joins: the
least bytes of its frame (``roofline.b1_bytes``) at 3.35 TB/s, over its
profiled device seconds. A trace without the kernel fails the run."""
from joinbench import roofline

KERNEL = "april_trichotomy_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    k = ctx.trace["kernels"].get(KERNEL)
    if k is None:
        raise RuntimeError(f"the trace shows no {KERNEL}")
    f = ctx.frame
    nbytes = roofline.b1_bytes(f["n_rows"], f["r_objects"], f["s_objects"],
                               ctx.lists["r"], ctx.lists["s"])
    return roofline.share_pct(nbytes * k["launches"], k["seconds"])
