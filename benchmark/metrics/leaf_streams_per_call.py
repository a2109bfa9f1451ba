"""Leaves queued on a CUDA stream of their own per call: the program's
`leaf_streams` count over the window's calls (root spans).  None where
the program does not count it (a version without the stream pool)."""

from benchmark import spans


def read(ctx):
    c = spans.counter()
    if c is None or not c.requests or "leaf_streams" not in c.counts:
        return None
    return c.counts["leaf_streams"] / c.requests
