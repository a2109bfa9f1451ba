"""Share of the window in which a dcli align run queues no shard forward
and waits for none: total time of the program's dcli.align spans less the
pipeline's forward and rerun phases (target parse, reads, the home card's
reverse pass, traceback and render), over the window."""

from benchmark import spans


def read(ctx):
    s = spans.seconds(("dcli.align",))
    if s is None:
        return None
    phases = ctx.phases or {}
    return 100.0 * (s - phases.get("forward", 0.0)
                    - phases.get("rerun", 0.0)) / ctx.window_s
