"""Device kernels, copies and fills in the traced window per call
completed."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["n_device_ops"] or not ctx.calls:
        return None
    return t["n_device_ops"] / len(ctx.calls)
