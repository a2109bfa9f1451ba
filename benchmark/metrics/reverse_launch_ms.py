"""Host ms per call queueing the begin-finding reverse pass (gathers,
reversed profile, launch): total time of the program's
pipeline.reverse_launch spans, per call."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(("pipeline.reverse_launch",))
