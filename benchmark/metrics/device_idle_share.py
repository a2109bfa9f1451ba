"""1 - (union of the device's kernel and copy intervals) / window, from the
benchmark's profiler trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
