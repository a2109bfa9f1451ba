"""Forwards of a target shard launched per dcli align run: the program's
`shard_forwards` count (one per mesh cell and pass of
parallel/dist.sharded_forward, word-tier re-runs included) over its
`dcli.align` spans.  None where the program records neither."""

from benchmark import spans


def read(ctx):
    c = spans.counter()
    if c is None or "shard_forwards" not in c.counts:
        return None
    runs = c.totals().get("dcli.align", (0,))[0]
    return c.counts["shard_forwards"] / runs if runs else None
