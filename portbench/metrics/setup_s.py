"""s: process start to the first timed step: imports, the kernels' build
or load, weights, the scene and its reference features, the program's
own set-up and the warm-up of the cell's shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
