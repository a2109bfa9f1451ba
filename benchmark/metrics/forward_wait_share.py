"""Share of the window the host spends blocked in the pipeline's
`forward` phase (one download per leaf), from pipeline.profiled."""


def read(ctx):
    if not ctx.phases or "forward" not in ctx.phases:
        return None
    return 100.0 * ctx.phases["forward"] / ctx.window_s
