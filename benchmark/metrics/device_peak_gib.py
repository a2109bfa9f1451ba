"""torch.cuda.max_memory_allocated over the window (reset at its start),
in GiB: a gain bought with memory shows here."""


def read(ctx):
    if not ctx.mem_peak_bytes:
        return None
    return ctx.mem_peak_bytes / 2 ** 30
