"""Share of the window in the sharded path's merge: total time of the
program's dist.merge spans (gathers to the home card, best-hit merge,
suboptimal scans and their merge, as the host queues them)."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("dist.merge",))
