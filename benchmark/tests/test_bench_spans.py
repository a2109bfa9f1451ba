"""A traced run of each cell (the plain CPU versions, at a small size)
gives a number for every per-layer metric that reads the program's spans
and counts.  In the batch cells the four host shares split host_share:
together they stay within it, as every span they read lies outside the
pipeline's phases and none is counted twice."""

import time

import pytest

from conftest import small

SPAN_METRICS = {
    "illumina_1M.batch": ["parse_share.illumina", "render_share.illumina",
                          "launch_share.illumina", "finish_share.illumina"],
    "iontorrent_5M.batch": ["parse_share.ion", "render_share.ion",
                            "launch_share.ion", "finish_share.ion"],
    "illumina_1M.local": ["syncs_per_call.local", "api_ms.local",
                          "launch_ms.local", "reverse_launch_ms.local"],
}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reads_every_span_metric(workload):
    from benchmark import harness

    cfg, traffic = small(workload)
    result, _ = harness.run_cell(workload, 2 ** 31 + 91, 0.01, True,
                                 time.perf_counter(), device="cpu",
                                 cfg=cfg, traffic=traffic)
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    names = SPAN_METRICS[workload]
    assert set(names) <= set(got)
    assert all(got[n] > 0 for n in names)
    if workload.endswith(".local"):
        # one forward and one reverse download per Aligner.align call
        assert got["syncs_per_call.local"] == 2.0
        return
    host = got["host_share." + names[0].split(".")[1]]
    assert sum(got[n] for n in names) <= host + 1e-6


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent's program has no profiling.last: every reader then
    returns None and raises nothing."""
    import types

    from benchmark import harness
    from ssw_tpu_torch import profiling

    monkeypatch.delattr(profiling, "last")
    ctx = types.SimpleNamespace(window_s=1.0)
    for names in SPAN_METRICS.values():
        for n in names:
            assert harness.reader(n)(ctx) is None
