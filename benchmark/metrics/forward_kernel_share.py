"""Summed device time of the kernels classed as forward
(layers/forward_kernel) over the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["kernel_s"].get("forward_kernel"):
        return None
    return 100.0 * t["kernel_s"]["forward_kernel"] / t["window_s"]
