"""BASELINE config 5's cells at a size a CPU run holds: the extended
target is make_data's 10M.fa byte for byte, a sharded4 run over a
[cpu] * 4 mesh (dcli align + merge) comes out correct and its control
does not, and the sharded path's readers read nothing from a program that
records none of their spans or counts."""

import importlib.util
import os
import time
import types

import pytest

from conftest import ROOT

from benchmark import check, control, gen, harness
from benchmark.plugins import plugin
from benchmark.tracing import summarize

NEW_READERS = ("shard_forwards_per_call.longtarget", "merge_share.longtarget",
               "peer_mib_per_call.longtarget", "tail_share.longtarget")


def make_data():
    spec = importlib.util.spec_from_file_location(
        "make_data_for_test", os.path.join(ROOT, "tools", "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_extended_target_is_make_10m(tmp_path):
    md = make_data()
    want_path = str(tmp_path / "10M.fa")
    want = md.make_10m(want_path, md.load_fasta_seq(md.ONE_M))
    _, cfg, _, _, _ = harness.cell_specs(harness.manifest(),
                                         "longtarget_10M.sharded4")
    got = plugin("targets", "extended").make(cfg["target"], str(tmp_path))
    assert got["seq"] == want and len(want) == 10_000_000
    with open(want_path, "rb") as f, open(got["path"], "rb") as g:
        assert f.read() == g.read()
    assert got["name"] == gen.fasta_name(want_path) == "chr3"


def small(tmp_path):
    """longtarget_10M / sharded4 cut to a CPU run: 3,000 bases of 1M.fa
    (past its leading N run) extended to 9,000, 8 reads a call in batches
    of 4."""
    base = gen.load_fasta_seq(os.path.join(ROOT, "benchmark", "data",
                                           "1M.fa"))[500_000:503_000]
    path = str(tmp_path / "base.fa")
    gen.write_fasta(path, "base", base)
    _, cfg, traffic, _, _ = harness.cell_specs(harness.manifest(),
                                               "longtarget_10M.sharded4")
    cfg, traffic = dict(cfg), dict(traffic)
    cfg["target"] = dict(cfg["target"], file=path, length=9000)
    cfg["reads_per_call"] = 8
    traffic.update(pool_calls=2, check_per_call=3, batch_reads=4)
    return cfg, traffic


def test_sharded4_run_on_cpu_is_correct(tmp_path):
    cfg, traffic = small(tmp_path)
    result, lines = harness.run_cell(
        "longtarget_10M.sharded4", 2 ** 31 + 91, 0.05, False,
        time.perf_counter(), device="cpu", cfg=cfg, traffic=traffic)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 8 and len(lines) == len(result["checks"])
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert "reads_per_s.illumina" in result["metrics"]
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}


def test_sharded4_traced_run_on_cpu_reads_the_sharded_path(tmp_path):
    cfg, traffic = small(tmp_path)
    result, _ = harness.run_cell(
        "longtarget_10M.sharded4", 17, 0.05, True, time.perf_counter(),
        device="cpu", cfg=cfg, traffic=traffic)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    # 2 batches x 2 strands x 4 shards, plus any word-tier re-runs
    assert m["shard_forwards_per_call.longtarget"] >= 16
    assert m["peer_mib_per_call.longtarget"] == 0  # one device: no peers
    assert 0 < m["merge_share.longtarget"] < 100
    assert 0 < m["tail_share.longtarget"] < 100
    # the harness's own summary survives the entry's device entry
    d = result["device"]
    assert d["count"] == 1 and 0 <= d["busy_s"] <= d["window_s"]
    assert harness.tracing.summarize is summarize


def test_sharded4_reports_every_card_of_its_mesh(tmp_path, monkeypatch):
    import torch

    cfg, traffic = small(tmp_path)
    d = plugin("entries", "dcli").Driver(cfg, traffic, 5,
                                         torch.device("cpu"), str(tmp_path))
    d.devices = [torch.device("cuda", i) for i in (0, 1, 2, 3)]
    peaks = {0: 7, 1: 11, 2: 5, 3: 9}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "H100")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev: peaks[dev.index])
    assert d.extra()["device"] == {"platform": "gpu", "kind": "H100",
                                   "count": 4, "memory_peak_bytes": 11}


@pytest.mark.parametrize("seed", [11, 12])
def test_sharded4_control_is_not_correct(tmp_path, seed):
    cfg, traffic = small(tmp_path)
    res = control.control_run("longtarget_10M.sharded4", seed, 3, "cpu",
                              harness.manifest(), cfg, traffic)
    assert not res["correct"]
    assert res["checks"]["sam_lines_differing"]["value"] > 0


def test_full_precision_in_the_programs_place_is_correct(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(check, "SAT_CONTROL", None)
    cfg, traffic = small(tmp_path)
    res = control.control_run("longtarget_10M.sharded4", 11, 3, "cpu",
                              harness.manifest(), cfg, traffic)
    assert res["correct"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_read_nothing_without_their_spans(name, monkeypatch):
    from ssw_tpu_torch import profiling

    # a window whose program recorded no dcli or dist span or count
    c = profiling.GcupsCounter()
    with profiling.profiled(c):
        with profiling.span("cli.main"):
            pass
    ctx = types.SimpleNamespace(window_s=1.0, phases={"forward": 0.5})
    assert harness.reader(name)(ctx) is None
    # and a version of the program without profiling.last()
    monkeypatch.delattr(profiling, "last")
    assert harness.reader(name)(ctx) is None
