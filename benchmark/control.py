"""The control of `correct`: the reference computed in a saturating signed
byte (every score capped at 127, check.SAT_CONTROL) put in the program's
place, compared by the cell's own comparison.  It has to come out not
correct.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3
        [--calls N] [--device cpu]

For each seed the cell's inputs are made as a run makes them (the
traffic's entries/<entry>.py driver), the window is taken to hold N whole
calls, the run's sample is drawn, and the answers the comparison reads are
the control's (compare/<entry>.py plant_control): the sampled reads' SAM
records or Alignment fields from the byte-precision reference.  Prints
one JSON line per seed and exits 0 when every seed came out not correct.
Nothing of the program is imported.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_run(workload: str, seed: int, calls: int, device, man=None,
                cfg=None, traffic=None) -> dict:
    import torch

    from benchmark import check, harness
    from benchmark.plugins import plugin

    man = man or harness.manifest()
    _, cfg0, traffic0, _, _ = harness.cell_specs(man, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    dev = torch.device(device)
    cmp = plugin("compare", traffic["entry"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sswctl_") as tmp:
        d = plugin("entries", traffic["entry"]).Driver(cfg, traffic, seed,
                                                       dev, tmp)
        cmp.plant_control(d, calls, dev, check.SAT_CONTROL)
        checks = cmp.compare(d, dev)
    return {"workload": workload, "seed": seed, "calls": calls,
            "correct": check.correct(checks), "seconds":
            time.perf_counter() - t0, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    ok = True
    for seed in args.seeds:
        res = control_run(args.workload, seed, args.calls, args.device)
        print(json.dumps(res), flush=True)
        ok &= not res["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
