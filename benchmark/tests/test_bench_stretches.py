"""forward_stretches_per_call reads the program's `forward_stretches`
count per call, and reads nothing from a program that does not count it
(the parent of the split target, or a run with no packed launch)."""

import types

import pytest

from benchmark import harness, spans


@pytest.mark.parametrize("counts,requests,want", [
    ({"syncs": 17, "forward_stretches": 1000}, 1, 1000.0),
    ({"leaf_streams": 10, "forward_stretches": 36_474}, 2, 18_237.0),
    ({"syncs": 17, "leaf_streams": 10}, 2, None),
    ({"forward_stretches": 4096}, 0, None),
])
def test_reader(monkeypatch, counts, requests, want):
    counter = types.SimpleNamespace(counts=counts, requests=requests,
                                    totals=dict)
    monkeypatch.setattr(spans, "counter", lambda: counter)
    ctx = types.SimpleNamespace(window_s=1.0)
    for name in ("forward_stretches_per_call.ion",
                 "forward_stretches_per_call.longtarget"):
        assert harness.reader(name)(ctx) == want


def test_reader_without_profiling_last(monkeypatch):
    from ssw_tpu_torch import profiling

    monkeypatch.delattr(profiling, "last")
    ctx = types.SimpleNamespace(window_s=1.0)
    assert harness.reader("forward_stretches_per_call.ion")(ctx) is None
