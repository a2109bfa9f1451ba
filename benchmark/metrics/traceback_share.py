"""Share of the window in the pipeline's host `traceback` phase (the
banded CIGAR traceback), from pipeline.profiled."""


def read(ctx):
    if not ctx.phases or "traceback" not in ctx.phases:
        return None
    return 100.0 * ctx.phases["traceback"] / ctx.window_s
