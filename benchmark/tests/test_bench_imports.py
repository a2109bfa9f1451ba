"""No module under benchmark/ imports JAX or the JAX package (top-level
names compared whole: ssw_tpu_torch begins with ssw_tpu), and the
reference's side imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ssw_tpu"}
REFERENCE_SIDE = {"reference", "gen", "check", "opcount", "plugins",
                  "compare", "scoring", "targets", "readmodels"}


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            if node.module == "benchmark":
                yield from ("benchmark." + a.name for a in node.names)


def files():
    return sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                            recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    for f in files():
        tops = {m.split(".")[0] for m in imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_reference_side_imports_nothing_of_the_program():
    """The reference's modules, and every comparison, target, read model
    and scoring module found by name."""
    sides = [f for f in files()
             if os.path.relpath(f, os.path.join(ROOT, "benchmark")).split(
                 os.sep)[0].removesuffix(".py") in REFERENCE_SIDE]
    assert len(sides) >= 11
    for f in sides:
        for m in imports(f):
            assert m.split(".")[0] != "ssw_tpu_torch", (f, m)
            if m.startswith("benchmark."):
                assert m.split(".")[1] in REFERENCE_SIDE, (f, m)


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness, benchmark.control, benchmark.tracing; "
            "import ssw_tpu_torch.cli, ssw_tpu_torch.api; "
            "from benchmark import harness; print(harness.forbidden_modules())"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
