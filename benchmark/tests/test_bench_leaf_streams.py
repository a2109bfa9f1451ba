"""leaf_streams_per_call reads the program's `leaf_streams` count per call,
and reads nothing from a program that does not count it (the parent of
the stream pool, or any CPU run, where nothing is pooled)."""

import types

import pytest

from benchmark import harness, spans


@pytest.mark.parametrize("counts,requests,want", [
    ({"syncs": 17, "leaf_streams": 10}, 2, 5.0),
    ({"syncs": 96, "leaf_streams": 96}, 3, 32.0),
    ({"syncs": 17}, 2, None),
    ({"leaf_streams": 4}, 0, None),
])
def test_reader(monkeypatch, counts, requests, want):
    counter = types.SimpleNamespace(counts=counts, requests=requests,
                                    totals=dict)
    monkeypatch.setattr(spans, "counter", lambda: counter)
    ctx = types.SimpleNamespace(window_s=1.0)
    for name in ("leaf_streams_per_call.ion",
                 "leaf_streams_per_call.illumina"):
        assert harness.reader(name)(ctx) == want


def test_reader_without_profiling_last(monkeypatch):
    from ssw_tpu_torch import profiling

    monkeypatch.delattr(profiling, "last")
    ctx = types.SimpleNamespace(window_s=1.0)
    assert harness.reader("leaf_streams_per_call.ion")(ctx) is None
