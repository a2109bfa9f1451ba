"""Host ms per call queueing the forward pass: total time of the
program's pipeline.launch spans, per call."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(("pipeline.launch",))
