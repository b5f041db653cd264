"""Seconds from the process's start until the first join can run: CUDA,
the kernel libraries, the layers from the seed, the APRIL builds and one
warm-up join."""


def read(ctx):
    return ctx.setup_s
