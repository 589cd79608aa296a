"""Seconds from the process's start to the window's: imports, the kernels'
build or load, weights, traffic and the warm-up calls (host clock)."""


def read(ctx):
    return ctx.setup_s
