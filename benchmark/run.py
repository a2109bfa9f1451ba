"""Run one cell of the ssw_tpu_torch benchmark on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 breakdown, and last
the compared numbers beside their limits (also the last lines of standard
error).  Exits non-zero and prints no result without a CUDA card, or when
jax, jaxlib, flax or ssw_tpu were imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path[0] = ROOT
    import torch

    from benchmark import harness

    cell = next((w for w in harness.manifest()["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print("imported in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
