"""GiB of device memory the window's joins held at their peak
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start); nothing on a run without a card."""


def read(ctx):
    return ctx.peak_window_bytes / 2 ** 30 if ctx.peak_window_bytes else None
