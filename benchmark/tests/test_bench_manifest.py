"""BENCHMARK.json against the contract it is written to, and every name
in it found by the harness."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    m = load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128


def test_names_units_and_entries():
    m = load()
    names = [c["name"] for c in m["configs"]]
    assert len(set(names)) == len(names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    cells = [w["name"] for w in m["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(cells)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(cells) // 4)
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= set(cells)
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(x["layer"])
        if "roofline" in x["name"]:
            assert x["name"].split(".")[0].endswith("_roofline")
            assert x["unit"] == "%"


def test_every_cell_reports_what_it_must():
    m = load()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e

    def cells_of(x):
        return set(x.get("workloads", [w["name"] for w in m["workloads"]]))

    for w in m["workloads"]:
        mine = [x for x in e2e.values() if w["name"] in cells_of(x)]
        assert "setup_s" in {x["name"] for x in mine} and len(mine) >= 2
        assert any(w["name"] in cells_of(x) for x in m["per_layer"])
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert cells_of(x) <= cells_of(e2e[x["moves"]])


def test_harness_finds_every_name():
    from benchmark import harness
    from benchmark.plugins import plugin

    m = load()
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.reader(x["name"]))
    for w in m["workloads"]:
        cell, cfg, traffic, _, _ = harness.cell_specs(m, w["name"])
        assert callable(plugin("entries", traffic["entry"]).Driver)
        cmp = plugin("compare", traffic["entry"])
        assert callable(cmp.compare) and callable(cmp.plant_control)
        assert callable(plugin("targets", cfg["target"]["kind"]).make)
        model = plugin("readmodels", cfg["reads"]["model"])
        assert callable(model.prepare) and callable(model.sample)
        assert callable(plugin("scoring", cfg["scoring"]["matrix"]).matrix)
    classes = harness.kernel_classes()
    assert classes["forward_kernel"]


def test_layers_are_named_alike():
    """Metrics of one layer give the same `layer`; every layer is one of
    PERF.md's list of layers."""
    m = load()
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for x in m["per_layer"]:
        assert f"**{x['layer']}**" in perf, x["layer"]


def test_a_metric_of_several_configurations_has_one_reader():
    """reads_per_s.<config> falls back to metrics/reads_per_s.py."""
    from benchmark import harness

    for name in ("reads_per_s.illumina", "reads_per_s.any_config"):
        path = harness.reader(name).__code__.co_filename
        assert path.endswith(os.path.join("metrics", "reads_per_s.py"))
