"""The port's observability (ssw_tpu_torch/profiling.py) on the CPU: the
span tree of one cli.main call and of Aligner.align calls, the phase
seconds, the `syncs` count against the pipeline's device->host downloads,
the cost when no counter is routed, the `ssw:` annotations on a
torch.profiler timeline, and the SSW_TPU_PROFILE and SSW_TPU_TRACE
switches of the two CLIs."""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from ssw_tpu_torch import api, cli, dcli, pipeline, profiling
from ssw_tpu_torch.parallel import mesh as mesh_lib

PHASES = {"forward", "rerun", "suboptimal", "reverse", "traceback"}
BASES = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool gains nothing here and only
    competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(seed=3, n_reads=6, rl=60, R=2000, err=0.05):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R)
    reads = []
    for k in range(n_reads):
        off = int(rng.integers(0, R - rl))
        r = ref[off:off + rl].copy()
        m = rng.random(rl) < err
        r[m] = rng.integers(0, 4, int(m.sum()))
        if k % 2:
            r = 3 - r[::-1]
        reads.append(r)
    return ref, reads


def _text(codes):
    return "".join(BASES[int(c)] for c in codes)


@pytest.fixture
def files(tmp_path):
    ref, reads = _seqs()
    t, q = tmp_path / "t.fa", tmp_path / "q.fastq"
    t.write_text(">chr\n" + _text(ref) + "\n")
    q.write_text("".join(f"@r{k}\n{_text(r)}\n+\n{'I' * len(r)}\n"
                         for k, r in enumerate(reads)))
    return str(t), str(q)


def _cli(files, *flags):
    out, err = io.StringIO(), io.StringIO()
    assert cli.main([*flags, *files], out=out, err=err, device="cpu") == 0
    return out.getvalue(), err.getvalue()


def _edges(c):
    """(span name, parent span name) of every closed span, after checking
    the tree: a child lies inside its parent and shares its request, self
    time is at most total time, one root per request."""
    by_id = {s[1]: s for s in c.spans}
    edges = set()
    for name, sid, parent, req, t0, t1 in c.spans:
        assert t0 <= t1
        if parent is None:
            edges.add((name, None))
            continue
        p = by_id[parent]
        assert p[3] == req and p[4] <= t0 and t1 <= p[5]
        edges.add((name, p[0]))
    for n, tot, own in c.totals().values():
        assert n > 0 and 0 <= own <= tot
    roots = [s for s in c.spans if s[2] is None]
    assert len(roots) == c.requests
    assert sorted(s[3] for s in roots) == list(range(c.requests))
    assert not c._open
    return edges


# the pipeline's spans under pipeline.mid and pipeline.finish (the full
# scan, no re-run)
PIPE = {("phase.forward", "pipeline.mid"), ("phase.reverse", "pipeline.mid"),
        ("pipeline.reverse_launch", "phase.reverse"),
        ("phase.reverse", "pipeline.finish"),
        ("pipeline.reverse_wait", "phase.reverse"),
        ("phase.traceback", "pipeline.finish")}


def test_span_tree_of_one_cli_call(files):
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        _cli(files, "-c", "-s", "-h", "-r")
    assert profiling.last() is c and profiling._counter is None
    assert _edges(c) == PIPE | {
        ("cli.main", None), ("cli.header", "cli.main"),
        ("cli.parse_target", "cli.main"), ("cli.reads", "cli.main"),
        ("pipeline.launch", "cli.reads"), ("pipeline.mid", "cli.reads"),
        ("pipeline.finish", "cli.reads"), ("cli.render", "cli.reads")}
    assert c.requests == 1
    # seconds holds the pipeline's phases only, each the sum of its spans
    assert set(c.seconds) == {"forward", "reverse", "traceback"}
    tot = c.totals()
    for name, s in c.seconds.items():
        assert s == pytest.approx(tot["phase." + name][1], abs=1e-9)


def test_span_tree_of_aligner_calls():
    ref, reads = _seqs(seed=5, n_reads=2)
    al = api.Aligner(device="cpu")
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        for r in reads:
            al.align(_text(r), _text(ref), mask_len=30)
    assert _edges(c) == PIPE | {
        ("api.align_batch", None), ("api.translate", "api.align_batch"),
        ("pipeline.align_batch", "api.align_batch"),
        ("api.alignments", "api.align_batch"),
        ("pipeline.launch", "pipeline.align_batch"),
        ("pipeline.mid", "pipeline.align_batch"),
        ("pipeline.finish", "pipeline.align_batch")}
    # one request per call, every span of a call in its request
    assert c.requests == 2
    assert c.totals()["api.align_batch"][0] == 2
    assert c.totals()["api.translate"][0] == 4
    assert set(c.seconds) <= PHASES
    assert c.counts == {"syncs": 4}


def _downloads(monkeypatch):
    """Records the line of every Tensor.cpu() the pipeline calls: its
    device->host downloads."""
    lines = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **k):
        f = sys._getframe(1)
        if f.f_code.co_filename == pipeline.__file__:
            lines.append(f.f_lineno)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    return lines


@pytest.mark.parametrize("route, sites", [
    ("full scan", 4),            # forward, both re-run downloads, reverse
    ("streaming", 3),            # forward, suboptimal, reverse (dual tier)
    ("streaming re-run", 4),     # forward, re-run, suboptimal, reverse
    ("sharded", 2),              # the sharded forward (and re-run), reverse
])
def test_syncs_count_every_download(route, sites, monkeypatch):
    # 150 bp reads might pass the byte tier (150 * 2 + bias >= 255), and
    # at 30 % substitutions do not: each re-runs, unless the dual tier
    # serves it
    ref, reads = _seqs(seed=7, n_reads=5, rl=150, R=3000, err=0.3)
    reads += _seqs(seed=8, n_reads=3, rl=150, R=3000, err=0.0)[1]
    mat = np.full((5, 5), -2, np.int8)
    np.fill_diagonal(mat, 2)
    mat[4] = mat[:, 4] = 0
    req = pipeline.BatchRequest(reads=[r.astype(np.int32) for r in reads],
                                ref=ref.astype(np.int32), mat=mat, gapO=3,
                                gapE=1, mask_len=75)
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", route != "full scan")
    if route == "streaming re-run":
        monkeypatch.setattr(pipeline, "DUAL", False)
    lines = _downloads(monkeypatch)
    c = profiling.GcupsCounter()
    with pipeline.profiled(c), contextlib.redirect_stderr(io.StringIO()):
        if route == "sharded":
            mesh = mesh_lib.make_mesh(data=2, seq=2,
                                      devices=[torch.device("cpu")] * 4)
            res = pipeline.align_batch_sharded(req, mesh)
        else:
            res = pipeline.align_batch(req, device="cpu")
    assert all(r.score1 > 0 for r in res)
    assert c.counts["syncs"] == len(lines) >= sites
    assert len(set(lines)) == sites
    assert set(c.seconds) <= PHASES


def test_nothing_recorded_without_a_counter():
    assert profiling._counter is None
    a, b = profiling.span("cli.main"), profiling.span("pipeline.launch")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert profiling.phase("forward") is a
    profiling.count("syncs")
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        pass
    ref, reads = _seqs(seed=9, n_reads=1)
    api.Aligner(device="cpu").align(_text(reads[0]), _text(ref))
    assert profiling.last() is c
    assert (c.spans, c.counts, c.seconds, c.requests, c.cells) == (
        [], {}, {}, 0, 0)


def test_spans_are_annotations_on_the_profilers_timeline():
    ref, reads = _seqs(seed=9, n_reads=1)
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        with c.span("outside") as s:
            assert s.annotation is None
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            api.Aligner(device="cpu").align(_text(reads[0]), _text(ref))
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    want = {"ssw:" + n for n in c.totals() if n != "outside"}
    assert "ssw:api.align_batch" in want and want <= names
    assert "ssw:outside" not in names


def test_profile_env_adds_the_report_line(files, monkeypatch):
    monkeypatch.delenv("SSW_TPU_PROFILE", raising=False)
    monkeypatch.delenv("SSW_TPU_TRACE", raising=False)
    out0, err0 = _cli(files, "-c", "-s", "-h")
    monkeypatch.setenv("SSW_TPU_PROFILE", "1")
    out1, err1 = _cli(files, "-c", "-s", "-h")
    assert out1 == out0
    lines = err1.strip().splitlines()
    assert lines[-2].startswith("CPU time:")
    assert not any(ln.startswith("{") for ln in err0.splitlines())
    rep = json.loads(lines[-1])
    assert set(rep) == {"cells", "seconds", "gcups_forward", "spans",
                        "counts"}
    assert rep["cells"] > 0 and rep["gcups_forward"] > 0
    assert set(rep["seconds"]) <= PHASES
    assert {"cli.main", "cli.parse_target", "cli.reads", "cli.render",
            "pipeline.launch"} <= set(rep["spans"])
    n, tot, own = rep["spans"]["cli.main"]
    assert n == 1 and 0 <= own <= tot
    assert rep["counts"]["syncs"] == 2


@pytest.mark.parametrize("front", ["cli", "dcli"])
def test_trace_env_alone_writes_a_trace(front, files, tmp_path, monkeypatch):
    monkeypatch.delenv("SSW_TPU_PROFILE", raising=False)
    monkeypatch.setenv("SSW_TPU_TRACE", str(tmp_path / "trace"))
    if front == "cli":
        _, err = _cli(files, "-c", "-s")
        want = {"ssw:cli.main", "ssw:cli.reads", "ssw:pipeline.launch",
                "ssw:phase.forward", "ssw:cli.render"}
    else:
        err = io.StringIO()
        assert dcli.main(["align", "-c", "-s", "--out",
                          str(tmp_path / "part"), *files], out=io.StringIO(),
                         err=err, device="cpu") == 0
        err = err.getvalue()
        want = {"ssw:phase.forward", "ssw:phase.reverse", "ssw:cli.render"}
    assert not any(ln.startswith("{") for ln in err.splitlines())
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert want <= names
