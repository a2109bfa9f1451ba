"""ssw_tpu_torch.bench, the counterpart of the root bench.py, on the CPU: its
timed call against the JAX package's scan backend on the same reads, its
inputs against the pipeline's own launch, its one line, and no fallback."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu.ops import common as jax_common
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu_torch import bench, pipeline
from ssw_tpu_torch.core.encoding import dna_matrix
from ssw_tpu_torch.ops import cuda_sw

N_READS, R = 64, 1 << 12  # bench.py's recipe at a reduced size


def _small_leaf():
    ref = bench.make_target(R)
    return ref, bench.Leaf(ref, N_READS, bench.READ_LEN, "cpu")


def _jax_forward(reads, ref, word: bool):
    """The JAX package's forward_shared_ref on the reads padded to L 256
    with the byte-tier (or word-tier) row geometry."""
    read_len = np.full(len(reads), bench.READ_LEN, np.int32)
    prof = jax_common.build_profile(
        jax_common.pad_reads(reads, bench.L, 5), read_len,
        jax_common.extend_matrix(dna_matrix(2, 2)))
    geo = jax_common.batch_geometry(read_len, bench.L, word=word)
    return jax_scan.forward_shared_ref(
        jnp.asarray(prof), jnp.asarray(ref), jnp.asarray(read_len),
        jnp.asarray(geo.col_mask), jnp.asarray(geo.seg_id),
        jnp.asarray(geo.seg_start), bench.GAP_O, bench.GAP_E, False)


def test_timed_call_equals_jax_scan():
    """Per read, the timed call's score and ends equal the JAX package's
    forward_shared_ref on the same reads padded to L 256; its block maxima
    (the dual tier's two channels) equal blockmax_reduce of that call's
    per-column maxima with the byte-tier and the word-tier row masks."""
    ref, leaf = _small_leaf()
    assert leaf.dual  # 200 bp at +2 might reach 255: the pipeline's tier
    reads = bench.make_reads(ref, 1, N_READS)
    got = [t.numpy() for t in leaf.call(leaf.inputs(reads))]
    score, end_ref, end_read, maxcol = _jax_forward(reads, ref, False)
    for g, w in zip(got[:3], (score, end_ref, end_read)):
        assert np.array_equal(g, np.asarray(w))
    assert got[3].shape == (N_READS, 2, R // 256)
    assert np.array_equal(got[3][:, 0], np.asarray(
        jax_scan.blockmax_reduce(maxcol, R)))
    maxcol_w = _jax_forward(reads, ref, True)[3]
    assert np.array_equal(got[3][:, 1], np.asarray(
        jax_scan.blockmax_reduce(maxcol_w, R)))


def test_inputs_are_the_pipelines_launch(monkeypatch):
    """The bench's launch is the one a streaming leaf of the same reads
    makes in pipeline.align_batch: the same packed profile, target and
    slot tables, and the same keyword arguments (the dual tier, no gate,
    no quirk, byte tier)."""
    ref, leaf = _small_leaf()
    reads = bench.make_reads(ref, 1, N_READS)
    seen = []

    class Launched(Exception):
        pass

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        raise Launched

    monkeypatch.setattr(cuda_sw, "forward_shared_packed", capture)
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=bench.GAP_O, gapE=bench.GAP_E)
    with pytest.raises(Launched):
        pipeline.align_batch(req, "cpu")
    with pytest.raises(Launched):
        leaf.call(leaf.inputs(reads))
    (pipe_args, pipe_kw), (args, kw) = seen
    assert len(args) == len(pipe_args) == 8
    for a, b in zip(args, pipe_args):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert kw == pipe_kw
    assert kw["dual"] is True and kw["gate"] is None
    assert kw["valid_len"] == R and not kw["quirk"] and not kw["word"]
    assert (leaf.plan.L, leaf.plan.S) == (1024, 4)


def test_main_prints_bench_py_line(monkeypatch, capsys):
    """--device cpu runs the same call through the plain version and
    prints bench.py's four keys as the last line."""
    monkeypatch.setattr(bench, "READS", N_READS)
    monkeypatch.setattr(bench, "CPU_R", R)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    info, last = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "GCUPS" and last["unit"] == "GCUPS"
    assert last["value"] > 0
    # both rounded to 0.01 from the same GCUPS, as bench.py does
    assert abs(last["vs_baseline"] - last["value"] / 1.1) <= 0.01
    assert bench.result_line(123.456) == {
        "metric": "GCUPS", "value": 123.46, "unit": "GCUPS",
        "vs_baseline": 112.23}
    assert info["device"] == "cpu" and info["cells"] == N_READS * 200 * R


def test_failed_launch_raises_without_a_line(monkeypatch, capsys):
    def fail(*args, **kwargs):
        raise RuntimeError("forward_shared_packed launch failed")

    monkeypatch.setattr(cuda_sw, "forward_shared_packed", fail)
    monkeypatch.setattr(bench, "READS", N_READS)
    monkeypatch.setattr(bench, "CPU_R", R)
    with pytest.raises(RuntimeError, match="launch failed"):
        bench.main(["--device", "cpu"])
    assert "GCUPS" not in capsys.readouterr().out


def test_main_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
    assert capsys.readouterr().out == ""
