"""Blocking device->host copies per call: the program's `syncs` count
over the window's calls (root spans)."""

from benchmark import spans


def read(ctx):
    c = spans.counter()
    if c is None or not c.requests:
        return None
    return c.counts.get("syncs", 0) / c.requests
