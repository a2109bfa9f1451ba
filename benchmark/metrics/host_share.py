"""Share of the window outside the pipeline's phases (front end: parsing,
encoding, rendering and writing): (window - sum of the phases' seconds) /
window, from the program's pipeline.profiled phases."""


def read(ctx):
    if not ctx.phases:
        return None
    return 100.0 * (ctx.window_s - sum(ctx.phases.values())) / ctx.window_s
