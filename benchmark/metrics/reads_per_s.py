"""Reads whose SAM records were written, over the whole window (host clock
from the start of the first call to the end of the last call begun inside
--seconds; whole calls only)."""


def read(ctx):
    if not ctx.window_s or not ctx.reads_done:
        return None
    return ctx.reads_done / ctx.window_s
