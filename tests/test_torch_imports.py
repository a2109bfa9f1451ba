"""The port stands alone and never hides the device: no module of
ssw_tpu_torch (and not chip_smoke.py) imports JAX or anything of ssw_tpu;
the default device is the CUDA card and its absence raises; a failed kernel
build or launch raises; chip_smoke.py without a card exits non-zero and
prints no result."""

import io
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssw_tpu_torch
from ssw_tpu_torch import api, bench, bridge, cli, pipeline, pyssw, ssw_lib
from ssw_tpu_torch.ops import _kernels, cuda_sw
from ssw_tpu_torch.tools import bench_protein, run_config4_full

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return ["ssw_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
        ssw_tpu_torch.__path__, "ssw_tpu_torch.")]


def _no_gpu_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_no_module_imports_jax_or_ssw_tpu():
    mods = _modules()
    assert {"ssw_tpu_torch.pipeline", "ssw_tpu_torch.cli",
            "ssw_tpu_torch.dcli", "ssw_tpu_torch.parallel.mesh",
            "ssw_tpu_torch.parallel.dist",
            "ssw_tpu_torch.parallel.multihost",
            "ssw_tpu_torch.tools.probe_swar", "ssw_tpu_torch.tools.probe_i16",
            "ssw_tpu_torch.tools.kernel_lab",
            "ssw_tpu_torch.tools.i16_fault",
            "ssw_tpu_torch.tools.sass_diff", "ssw_tpu_torch.api",
            "ssw_tpu_torch.ssw_lib", "ssw_tpu_torch.pyssw",
            "ssw_tpu_torch.bridge", "ssw_tpu_torch.bench",
            "ssw_tpu_torch.tools.run_config4_full",
            "ssw_tpu_torch.tools.bench_protein"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'ssw_tpu' or "
        "m.startswith('ssw_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=_no_gpu_env())
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = pipeline.BatchRequest(reads=[np.array([0, 1, 2, 3], np.int8)],
                                ref=np.array([0, 1, 2, 3], np.int8),
                                mat=np.eye(5, dtype=np.int8), gapO=3, gapE=1)
    data = [os.path.join(ROOT, "tests", "data", f)
            for f in ("1k.fa", "test.seq")]
    read, ref = "CTGAGCCGGTAAATC", "CAGCCTTTCTGACCCGGAAATCAAAATAGG"
    flat = [int(x) for x in np.eye(5, dtype=np.int8).reshape(-1)]
    ssw = ssw_lib.CSsw()
    for call in (lambda: pipeline.align_batch(req),
                 lambda: pipeline.align_batch_launch(req),
                 lambda: pipeline.align_batch(req, device="cuda"),
                 lambda: cli.main(data),
                 lambda: api.align(req.reads[0], req.ref, 3, 1, mat=req.mat),
                 lambda: api.align_batch(req.reads, req.ref, req.mat, 3, 1),
                 lambda: api.Aligner().align(read, ref),
                 lambda: ssw.ssw_align(ssw.ssw_init([0, 1, 2], 3, flat, 5, 2),
                                       [0, 1, 2, 3], 4, 3, 1, 0x0F, 0,
                                       2 ** 15, 15),
                 lambda: pyssw.main(data, out=io.StringIO(),
                                    err=io.StringIO()),
                 lambda: bridge.serve(io.StringIO("{}\n"), io.StringIO()),
                 lambda: bridge.start(),
                 lambda: bench.main([]),
                 lambda: run_config4_full.run(*data),
                 lambda: bench_protein.run(req.reads, req.ref, req.mat,
                                           False)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert pipeline.resolve_device("cpu").type == "cpu"


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'sw_forward.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error: boom"):
        _kernels.build(("sw_forward",))
    assert not list((tmp_path / "build").glob("*.so"))


def test_launch_error_code_raises():
    class Lib:
        @staticmethod
        def sw_error_string(rc):
            return b"too many resources requested for launch"

    cuda_sw._raise_on(Lib, 0, "forward_shared")  # 0 is success
    with pytest.raises(RuntimeError, match="too many resources"):
        cuda_sw._raise_on(Lib, 701, "forward_shared")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=_no_gpu_env())


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
