"""The forward kernels' share of their roofline: the least time the
window's forward work needs at the card's peak (opcount.py: full read x
target cells per strand, 16-bit pairs) over the summed device time of the
kernels classed as forward.  None without a known peak or a forward
kernel in the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.peak_cells_per_s or not ctx.forward_cells:
        return None
    busy = t["kernel_s"].get("forward_kernel")
    if not busy:
        return None
    return 100.0 * ctx.forward_cells / ctx.peak_cells_per_s / busy
