"""A run drives the program (its plain CPU versions, at a small size) and
its comparison comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault a cell can have: an answer
altered where it is produced, half of the batch left out, and (for the
one-read calls) an answer left as the previous call's."""

import time

import pytest

from conftest import small

CELLS = ["illumina_1M.batch", "iontorrent_5M.batch", "illumina_1M.local"]


def run(workload):
    from benchmark import harness

    cfg, traffic = small(workload)
    result, lines = harness.run_cell(workload, 2 ** 31 + 77, 0.05, False,
                                     time.perf_counter(), device="cpu",
                                     cfg=cfg, traffic=traffic)
    assert list(result)[-1] == "checks" and len(lines) == len(
        result["checks"])
    return result


def alter_answers(monkeypatch):
    from ssw_tpu_torch import pipeline

    real = pipeline._finish_complete

    def altered(*a, **k):
        out = real(*a, **k)
        for r in out:
            if r is not None and r.score1 > 0:
                r.score1 += 1
        return out

    monkeypatch.setattr(pipeline, "_finish_complete", altered)


def drop_half(monkeypatch, workload):
    from ssw_tpu_torch import api, cli

    if workload.endswith(".local"):
        real = api.Aligner.align
        n = [0]

        def half(self, *a, **k):
            n[0] += 1
            return (0, api.Alignment()) if n[0] % 2 else real(self, *a, **k)

        monkeypatch.setattr(api.Aligner, "align", half)
    else:
        real = cli.render_results

        def half(*a, **k):
            out = real(*a, **k)
            return [t if i % 2 else "" for i, t in enumerate(out)]

        monkeypatch.setattr(cli, "render_results", half)


def stale(monkeypatch):
    from ssw_tpu_torch import api

    real = api.Aligner.align
    last = []

    def previous(self, *a, **k):
        now = real(self, *a, **k)
        out = last[0] if last else now
        last[:] = [now]
        return out

    monkeypatch.setattr(api.Aligner, "align", previous)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_is_caught(workload, monkeypatch):
    alter_answers(monkeypatch)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out_is_caught(workload, monkeypatch):
    drop_half(monkeypatch, workload)
    assert not run(workload)["correct"]


def test_stale_answer_is_caught(monkeypatch):
    stale(monkeypatch)
    assert not run("illumina_1M.local")["correct"]
