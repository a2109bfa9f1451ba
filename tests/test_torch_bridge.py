"""ssw_tpu_torch.bridge (device "cpu") against ssw_tpu.bridge (JAX on the
CPU): the cases of tests/test_bridge.py, serve byte-equal to the JAX
worker's serve on the same lines (single and batched requests, every error
line), the worker as a subprocess with SSW_TPU_BRIDGE_PLATFORM=cpu fed the
Java client's byte-exact frames (tests/test_java_protocol_replay.py) with
responses byte-equal to the JAX worker's, the C client of bindings/c
through the launcher, the platform variable, and a worker without a card,
which exits non-zero before it answers."""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import test_java_protocol_replay as proto
import test_jvm_bridge as jvm
from ssw_tpu import bridge as jbridge
from ssw_tpu_torch import bridge
from ssw_tpu_torch.core.encoding import dna_matrix, encode_dna
from test_jvm_bridge import (_batch_frame, _example_pair_frame,  # noqa: F401
                             _protein_frame, harness_cls)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C_SRC = os.path.join(ROOT, "bindings", "c")
REF = "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"
READ = "CTGAGCCGGTAAATC"
SHUTDOWN = '{"op":"shutdown"}'


def _serve_text(lines, jax=False):
    out = io.StringIO()
    inp = io.StringIO("\n".join(lines) + "\n")
    if jax:
        rc = jbridge.serve(inp=inp, out=out)
    else:
        rc = bridge.serve(inp=inp, out=out, device="cpu")
    assert rc == 0
    return out.getvalue()


def _serve(lines):
    """The port's responses to `lines`, after holding them byte-equal to
    the JAX worker's."""
    got = _serve_text(lines)
    assert got == _serve_text(lines, jax=True)
    return [json.loads(l) for l in got.splitlines()]


def _example_request(rid=0, **over):
    msg = {
        "id": rid,
        "read": [int(x) for x in encode_dna(READ)],
        "ref": [int(x) for x in encode_dna(REF)],
        "matrix": [int(x) for x in dna_matrix(2, 2).ravel()],
        "n": 5, "gap_open": 3, "gap_extend": 1, "flag": 1, "mask_len": 15,
    }
    msg.update(over)
    return msg


def _env(**kw):
    env = dict(os.environ, **kw)
    env.pop("PYTHONPATH", None)
    return env


def test_bridge_example_pair():
    resp = _serve([json.dumps(_example_request()), SHUTDOWN])
    r = resp[0]["result"]
    # reference example.c expected result (score 21, ref 8..21, read 0..14)
    assert r["score1"] == 21
    assert (r["ref_begin1"], r["ref_end1"]) == (8, 21)
    assert (r["read_begin1"], r["read_end1"]) == (0, 14)
    assert r["cigar_string"] == "9M1I5M"


def test_bridge_batch_and_errors():
    batch = {"id": 7, "batch": [_example_request(),
                                _example_request(flag=0x0F, mask_len=3)]}
    missing = _example_request(rid=11)
    del missing["gap_open"]
    resp = _serve([
        "not json",
        "",
        json.dumps(batch),
        json.dumps(_example_request(rid=9, n="bogus")),
        json.dumps(_example_request(rid=10, n=4)),
        json.dumps(missing),
        json.dumps({"id": 12, "batch": [_example_request(), missing]}),
        json.dumps({"id": 13, "batch": []}),
        json.dumps(_example_request(rid=14, filter_distance=None)),
        SHUTDOWN,
        json.dumps(_example_request(rid=99)),
    ])
    assert resp[0] == {"error": "bad json"}
    assert resp[1]["id"] == 7 and len(resp[1]["result"]) == 2
    assert resp[1]["result"][0]["score1"] == 21
    assert [r["id"] for r in resp[2:6]] == [9, 10, 11, 12]
    assert all("error" in r for r in resp[2:6])
    assert resp[6] == {"id": 13, "result": []}
    assert resp[7]["result"]["score1"] == 21
    assert len(resp) == 8  # nothing answered after shutdown


def test_batch_request_matches_per_item():
    """The batched wire form runs grouped device batches; results equal
    per-item requests and the JAX worker's, incl. mixed configs and NULL
    results (score_size=0 overflow)."""
    rng = np.random.default_rng(3)
    ref = [int(x) for x in rng.integers(0, 4, 300)]
    mat = [2 if (i == j and i < 4) else (-2 if i < 4 and j < 4 else 0)
           for i in range(5) for j in range(5)]

    def req(read, **kw):
        base = {"read": read, "ref": ref, "matrix": mat, "n": 5,
                "gap_open": 3, "gap_extend": 1, "flag": 0x0F,
                "mask_len": 15, "score_size": 2}
        base.update(kw)
        return base

    reads = [ref[10:90], ref[50:120], [int(x) for x in rng.integers(0, 4, 70)],
             ref[0:280]]
    msgs = [req(reads[0]), req(reads[1], gap_open=5, gap_extend=2),
            req(reads[2]), req(reads[3], score_size=0),
            req(reads[1], gap_open=1, gap_extend=2), req(reads[0][:12])]
    batch = bridge._align_many(msgs, "cpu")
    single = [bridge._align_one(m, "cpu") for m in msgs]
    assert json.dumps(batch) == json.dumps(single)
    assert batch[3] is None
    assert bridge._dumps(batch) == jbridge._dumps(jbridge._align_many(msgs))


@pytest.mark.parametrize("value,device", [
    (None, None), ("", None), ("cuda", None), ("gpu", None), ("cpu", "cpu")])
def test_platform_variable(monkeypatch, value, device):
    if value is None:
        monkeypatch.delenv(bridge.PLATFORM_ENV, raising=False)
    else:
        monkeypatch.setenv(bridge.PLATFORM_ENV, value)
    assert bridge.env_device() == device


def test_bad_platform_value_exits_before_answering():
    r = subprocess.run(
        [sys.executable, "-m", "ssw_tpu_torch.bridge"],
        input=json.dumps(_example_request()) + "\n", capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env=_env(SSW_TPU_BRIDGE_PLATFORM="tpu"))
    assert r.returncode != 0 and r.stdout == ""
    assert "SSW_TPU_BRIDGE_PLATFORM='tpu'" in r.stderr


def test_worker_without_a_card_exits_before_answering():
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("SSW_TPU_BRIDGE_PLATFORM", None)
    r = subprocess.run(
        [sys.executable, "-m", "ssw_tpu_torch.bridge"],
        input=json.dumps(_example_request()) + "\n", capture_output=True,
        text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode != 0 and r.stdout == ""
    assert "is_available" in r.stderr


@pytest.fixture(scope="module")
def java(tmp_path_factory):
    """A JVM as tests/test_jvm_bridge.py finds one, but the embedded JRE
    unzipped into this module's own directory: a worker running that
    module at the same time may be unzipping into the shared one."""
    j = shutil.which("java")
    if j:
        return j
    if not (os.path.exists(jvm.BAZEL_REAL) and shutil.which("unzip")):
        pytest.skip("no JVM on this image (PATH or bazel embedded JRE)")
    d = tmp_path_factory.mktemp("jre")
    subprocess.run(["unzip", "-q", "-o", jvm.BAZEL_REAL,
                    "embedded_tools/jdk/*", "-d", str(d)],
                   capture_output=True, timeout=120)
    j = d / "embedded_tools" / "jdk" / "bin" / "java"
    if not j.exists():
        pytest.skip("the bazel embedded JRE did not unzip")
    return str(j)


def _frames():
    return (_example_pair_frame() + _batch_frame() + _protein_frame()
            + "this is not json\n" + SHUTDOWN + "\n").encode()


def _worker(module, frames, cmd=None):
    r = subprocess.run(cmd or [sys.executable, "-m", module], input=frames,
                       capture_output=True, timeout=600, cwd=ROOT,
                       env=_env(SSW_TPU_BRIDGE_PLATFORM="cpu"))
    assert r.returncode == 0, r.stderr[-800:]
    return r.stdout


def test_java_frames_through_the_worker_equal_jax(tmp_path):
    """The Java client's byte-exact frames (Aligner.align, alignBatch, a
    protein/quirk frame, a bad line) through a `python -m
    ssw_tpu_torch.bridge` worker, and again through the launcher as the
    Java client's ssw.python: byte-equal to the JAX worker's responses and
    parsed by the client's parser."""
    frames = _frames()
    got = _worker("ssw_tpu_torch.bridge", frames)
    assert got == _worker("ssw_tpu.bridge", frames)
    launcher = bridge.write_launcher(str(tmp_path / "python"))
    assert _worker(None, frames, [launcher, "-m", "ssw_tpu.bridge"]) == got
    lines = got.decode().splitlines()
    aln = proto.parse(lines[0])
    assert (aln["score1"], aln["ref_begin1"], aln["ref_end1"],
            aln["read_begin1"], aln["read_end1"], aln["cigar"]) == (
        21, 8, 21, 0, 14, "9M1I5M")
    assert '"result":[' in lines[1] and '"error"' not in lines[1]
    assert proto.parse(lines[2])["score1"] == 7 * 16
    assert lines[3] == '{"error":"bad json"}'
    assert len(lines) == 4


@pytest.mark.skipif(not shutil.which("gcc"), reason="no gcc on this image")
def test_c_client_through_the_launcher(tmp_path):
    """bindings/c's example against the port's worker: the C client execs
    `<python> -m ssw_tpu.bridge`, and the launcher given as <python> runs
    ssw_tpu_torch.bridge instead.  Its output equals the example's run
    against the JAX worker byte for byte."""
    exe = str(tmp_path / "example_c")
    subprocess.run(
        ["gcc", "-O2", "-Wall", "-o", exe,
         os.path.join(C_SRC, "example_c.c"),
         os.path.join(C_SRC, "ssw_client.c")],
        check=True, capture_output=True, timeout=120)
    launcher = bridge.write_launcher(str(tmp_path / "launch_bridge"))
    env = _env(SSW_TPU_BRIDGE_PLATFORM="cpu")
    runs = [subprocess.run([exe, ROOT, py], capture_output=True, text=True,
                           timeout=600, env=env)
            for py in (launcher, sys.executable)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-800:]
    out = runs[0].stdout
    assert out == runs[1].stdout
    # ref: src/example.c golden values (1-based like ssw_write's output)
    assert "optimal_alignment_score: 21" in out
    assert "sub-optimal_alignment_score: 8" in out
    assert "target_begin: 9" in out and "target_end: 22" in out
    assert "query_begin: 1" in out and "query_end: 15" in out
    assert "cigar: 9M1I5M" in out


def test_jvm_transit_to_the_port_worker(java, harness_cls,  # noqa: F811
                                        tmp_path):
    """A real JVM (tools/jvm_asm.py's SswJvmPipe) spawning the port's
    worker through the launcher, as the Java client does with
    -Dssw.python: byte-equal to the JAX worker fed the frames directly."""
    frames = _frames()
    ff = tmp_path / "frames.jsonl"
    ff.write_bytes(frames)
    launcher = bridge.write_launcher(str(tmp_path / "python"))
    r = subprocess.run(
        [java, "-cp", harness_cls, "SswJvmPipe", str(ff), launcher, "-m",
         "ssw_tpu.bridge"], capture_output=True, timeout=600, cwd=ROOT,
        env=_env(SSW_TPU_BRIDGE_PLATFORM="cpu"))
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == _worker("ssw_tpu.bridge", frames)
