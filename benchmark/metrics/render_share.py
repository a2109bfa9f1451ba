"""Share of the window rendering SAM or BLAST text and writing it: total
time of the program's cli.render spans."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("cli.render",))
