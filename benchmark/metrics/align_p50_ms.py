"""Median of every Aligner.align call of the window, each timed from call
to return with the result on the host (host clock)."""

import math


def read(ctx):
    lat = sorted(ctx.latencies_s or [])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.50 * len(lat)) - 1]
