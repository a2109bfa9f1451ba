"""The program's spans and counts over the traced window, for the
per-layer readers: ssw_tpu_torch.profiling.last() is the counter the
window routed through pipeline.profiled.  Every function returns None
where the program records no spans (a version without them)."""


def counter():
    from ssw_tpu_torch import profiling

    last = getattr(profiling, "last", None)
    c = last() if last is not None else None
    return c if hasattr(c, "totals") else None


def seconds(names, kind: str = "total"):
    """Summed total or self seconds of the spans `names` (kind "total" or
    "self"), or None when none of them was recorded."""
    c = counter()
    if c is None:
        return None
    tot = c.totals()
    found = [tot[n] for n in names if n in tot]
    if not found:
        return None
    i = 1 if kind == "total" else 2
    return sum(t[i] for t in found)


def share(ctx, names, kind: str = "total"):
    """Those seconds as a % of the window."""
    s = seconds(names, kind)
    return None if s is None else 100.0 * s / ctx.window_s


def per_call_ms(names, kind: str = "total"):
    """Those seconds in ms per call (root span) of the window."""
    s, c = seconds(names, kind), counter()
    return None if s is None or not c.requests else 1e3 * s / c.requests
