"""The reference-binary fuzz of tests/test_fuzz_reference.py pointed at the
port: random FASTA/FASTQ workloads (its _random_workload) under each of its
OPTSETS, the port's cli.main on device "cpu" against the JAX package's
ssw_tpu.cli.main (JAX on the CPU), stdout byte-equal and the stderr lines
equal as a multiset (its _strip_volatile).  Seeds 11 and 121 are its
default-tier seeds; 121 pins the banded tail fix-up overrun.  Where the
reference source is mounted, each case must also equal the reference
binary; without it that comparison skips and the JAX one still runs."""

import contextlib
import io
import os
import random
import subprocess

import pytest

from ssw_tpu_torch import cli as torch_cli
from test_fuzz_reference import OPTSETS, REF_SRC, _random_workload, \
    _strip_volatile

SEEDS = (11, 121)


@pytest.fixture(scope="module")
def ref_binary(tmp_path_factory):
    """The reference ssw_test built from REF_SRC, or None without it."""
    if not os.path.isdir(REF_SRC):
        return None
    out = tmp_path_factory.mktemp("refbin") / "ssw_test"
    r = subprocess.run(["gcc", "-O2", "-o", str(out),
                        os.path.join(REF_SRC, "main.c"),
                        os.path.join(REF_SRC, "ssw.c"), "-lm", "-lz"],
                       capture_output=True)
    return str(out) if r.returncode == 0 else None


def _run(main, args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(args, out=out, err=err, **kw)
    assert rc == 0
    return out.getvalue(), _strip_volatile(err.getvalue())


def _workload(seed, k, tmp):
    """The k-th workload of seed's sequence, as test_fuzz_byte_parity
    draws it."""
    rng = random.Random(seed)
    for j in range(k + 1):
        t, q = _random_workload(rng, tmp, f"{seed}_{j}")
    return t, q


@pytest.mark.parametrize("seed,k", [(s, k) for s in SEEDS
                                    for k in range(len(OPTSETS))])
def test_fuzz_port_equals_jax(seed, k, tmp_path, ref_binary):
    from ssw_tpu import cli as jax_cli

    t, q = _workload(seed, k, str(tmp_path))
    args = OPTSETS[k] + [t, q]
    ours = _run(torch_cli.main, args, device="cpu")
    assert ours == _run(jax_cli.main, args), f"port != ssw_tpu for {args}"
    if ref_binary is not None:
        r = subprocess.run([ref_binary] + args, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0
        assert ours == (r.stdout, _strip_volatile(r.stderr)), \
            f"port != reference binary for {args}"
