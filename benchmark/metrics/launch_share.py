"""Share of the window queueing device work: total time of the program's
pipeline.launch spans (leaf plan, packed inputs, profile, uploads, kernel
enqueues)."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("pipeline.launch",))
