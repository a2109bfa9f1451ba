"""Warps of the packed forward launches per call: the program's
`forward_stretches` count (reads times the stretches each read's target
is split into) over the window's calls (root spans).  It equals the reads
per call where nothing splits.  None where the program does not count it
(a version without the split target)."""

from benchmark import spans


def read(ctx):
    c = spans.counter()
    if c is None or not c.requests or "forward_stretches" not in c.counts:
        return None
    return c.counts["forward_stretches"] / c.requests
