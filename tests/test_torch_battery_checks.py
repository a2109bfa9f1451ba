"""The port's spotcheck_revmem, spotcheck_cuda and bench_suite
(ssw_tpu_torch/tools) on the CPU, held against the JAX package: the reverse
pass at (B 4, L 64, W 128) against ssw_tpu.pipeline._reverse_core with the
scan backend; spotcheck_cuda's cases against the draws of
tools/spotcheck_tpu.py and one cut case against ssw_tpu.api.align_batch on
the scan backend; bench_suite --device cpu --skip-e2e --mesh-repeat 2 with
the keys of the JAX tool's --platform cpu report.  Integer outputs:
tolerance 0."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu import api as jax_api
from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.ops import common as jax_common
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.ops import common
from ssw_tpu_torch.tools import bench_suite, spotcheck_cuda, spotcheck_revmem


def test_reverse_core_matches_jax(capsys):
    B, L, W = 4, 64, 128
    res, inp, out = spotcheck_revmem.run(B, L, W, "cpu")
    assert (res["B"], res["L"], res["W"], res["device"]) == (B, L, W, "cpu")
    assert res["transient_bytes"]["reversed_windows"] == 4 * B * W
    assert res["peak_bytes_in_use"] is None
    assert "'wall_s'" in capsys.readouterr().out
    assert inp["reads_d"].dtype == inp["mat_ext_d"].dtype == torch.int8
    n = spotcheck_revmem.N
    ref = np.asarray(inp["ref_dev"])[:spotcheck_revmem.TARGET].astype(np.int8)
    Rp = jax_common.bucket_size(len(ref), 256)
    want = jax_pipeline._reverse_core(
        jnp.asarray(inp["reads_d"].numpy()), jnp.asarray(inp["er"].numpy()),
        jnp.asarray(inp["ed"].numpy()), jnp.asarray(inp["score1"].numpy()),
        jax_pipeline._device_ref(ref, n, Rp),
        jnp.asarray(inp["mat_ext_d"].numpy()), L=L, W=W, n=n, gapO=3,
        gapE=1, quirk=False, tier_word=True, pallas=False)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        spotcheck_revmem.reverse(inp, rows=2).numpy(), out[:, :2].numpy())


@pytest.fixture(scope="module")
def jax_cases():
    """The reads, target, matrix and gaps tools/spotcheck_tpu.py draws for
    each case, captured by standing in for its check functions."""
    path = list(sys.path)
    try:
        from tools import spotcheck_tpu as tool
    finally:
        sys.path[:] = path
    got = []

    def capture(tag, reads, ref, mat, gapO, gapE):
        got.append((tag, reads, ref, np.asarray(mat), gapO, gapE))
        return 0

    mp = pytest.MonkeyPatch()
    mp.setattr(tool, "check", capture)
    mp.setattr(tool, "check_sharded", capture)
    try:
        tool.main()
    finally:
        mp.undo()
    return got


def test_spotcheck_cases_are_the_jax_tools(jax_cases):
    cases = spotcheck_cuda.cases()
    assert [c["tag"] for c in cases] == [c[0] for c in jax_cases]
    for c, (tag, reads, ref, mat, gapO, gapE) in zip(cases, jax_cases):
        assert len(c["reads"]) == len(reads), tag
        assert all(np.array_equal(a, b) for a, b in zip(c["reads"], reads))
        assert np.array_equal(c["ref"], ref), tag
        assert np.array_equal(c["mat"], mat), tag
        assert (c["gapO"], c["gapE"]) == (gapO, gapE), tag
    cut = spotcheck_cuda.cases(8)
    assert all(len(c["reads"]) == 8 for c in cut)
    assert all(np.array_equal(a, b) for a, b in zip(cut[0]["reads"],
                                                   cases[0]["reads"]))
    # 40,000 columns do not stream by the port's rule: the tool forces it
    big = cases[2]
    L = common.bucket_size(common.pad_total(max(map(len, big["reads"])),
                                            False), 64)
    assert not pipeline._use_streaming(
        common.bucket_size(len(big["ref"]), 256), L)
    assert big["stream"] and cases[3]["stream"] and cases[3]["pack_l"] == 1024


def test_spotcheck_cut_case_matches_jax_scan(capsys):
    case = spotcheck_cuda.cases(10)[1]  # dna-m1x3o5e2: -o5 -e2
    assert spotcheck_cuda.check(case, "cpu") == 0
    assert "dna-m1x3o5e2: 10 pairs, 0 mismatches" in capsys.readouterr().out
    got = [spotcheck_cuda.fields(x) for x in spotcheck_cuda._align(
        case, "cpu", None)]
    want = [spotcheck_cuda.fields(x) for x in jax_api.align_batch(
        case["reads"], case["ref"], case["mat"], case["gapO"], case["gapE"],
        backend="scan")]
    assert got == want


def test_bench_suite_cpu_keys(monkeypatch, capsys):
    # the forward section on 2^10 columns and one launch, the scaling on
    # 2048 (the tool's CPU sizes, 2^14 and two, and 16,384, take minutes)
    monkeypatch.setitem(bench_suite.FORWARD_SIZE, "cpu", (1 << 10, 128))
    monkeypatch.setattr(bench_suite, "SCALING_SIZE", (64, 128, 2048))
    assert bench_suite.main(["--device", "cpu", "--skip-e2e",
                             "--mesh-repeat", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"forward", "scaling"}
    assert set(report["forward"]) == {"gcups", "platform", "seconds",
                                      "device"}
    assert report["forward"]["platform"] == "cpu"
    assert report["forward"]["gcups"] > 0
    assert set(report["scaling"]) == {"data=1", "data=2",
                                      "collective_overhead_vs_single",
                                      "note", "device"}
    assert report["scaling"]["note"].startswith("virtual CPU mesh")


def test_bench_suite_scaling_outputs_equal_across_meshes(monkeypatch):
    """The tool compares every mesh's outputs with s = 1's: a mesh whose
    outputs differ fails it."""
    from ssw_tpu_torch.parallel import dist

    real, calls = dist.sharded_forward, []

    def off_by_one(mesh, *args, **kw):
        out = real(mesh, *args, **kw)
        calls.append(mesh.shape["data"])
        return (out[0] + (mesh.shape["data"] > 1),) + tuple(out[1:])

    monkeypatch.setattr(dist, "sharded_forward", off_by_one)
    monkeypatch.setattr(bench_suite, "SCALING_SIZE", (64, 128, 2048))
    with pytest.raises(AssertionError, match="mesh of 2"):
        bench_suite.bench_scaling(bench_suite.device_pool("cpu", 2))
    assert calls == [1, 1, 2, 2]
