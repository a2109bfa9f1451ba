"""Share of the window in the pipeline's host work between its waits:
self time of the program's pipeline.mid and pipeline.finish spans (tier
resolution, the per-read result loops), their phases excluded."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("pipeline.mid", "pipeline.finish"), "self")
