"""Host ms per call in Aligner's own code: self time of the program's
api.align_batch, api.translate and api.alignments spans, per call."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(("api.align_batch", "api.translate",
                              "api.alignments"), "self")
