"""Shared helpers of the benchmark's own CPU tests (run with
`python -m pytest benchmark/tests -q`; the repository's tests/ run does
not collect them)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small(workload: str):
    """The cell's configuration and traffic at a size a CPU run holds."""
    from benchmark import harness

    _, cfg, traffic, _, _ = harness.cell_specs(harness.manifest(), workload)
    cfg, traffic = dict(cfg), dict(traffic)
    cfg["target"] = {"kind": "uniform", "length": 3000, "seed": 1,
                     "name": "small\tcpu"}
    cfg["reads_per_call"] = 8
    traffic.update(pool_calls=2, check_per_call=3, block=16, check_calls=8,
                   warmup_calls=2)
    return cfg, traffic


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
