"""Process start to the start of the window: imports, kernel libraries,
data made from the seed and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
