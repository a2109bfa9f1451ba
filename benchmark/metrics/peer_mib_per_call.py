"""MiB copied between two distinct cards per dcli align run: the
program's `peer_bytes` count (parallel/dist.sharded_forward's inputs to
the shards, candidates back to the home card) / 2^20 over its
`dcli.align` spans.  None where the program records neither."""

from benchmark import spans


def read(ctx):
    c = spans.counter()
    if c is None or "peer_bytes" not in c.counts:
        return None
    runs = c.totals().get("dcli.align", (0,))[0]
    return c.counts["peer_bytes"] / 2 ** 20 / runs if runs else None
