"""The reference's headline workload (its README.md:66-72): the counterpart
of the JAX package's tools/bench_iontorrent.py.

1000 Ion Torrent-like reads (25-540 bp, most about 200 bp) against a
4.9 Mbp genome, default penalties, the whole CLI with -c -s -h, from
bench_data/ecoli_synth.fa and bench_data/iontorrent_1k.fastq (both written
by tools/make_data.py).  Reference: about 880 s (AMD) / 960 s (Intel) on
one core.  A cold run (the first call in the process: on the card the
kernel libraries' load and the target's upload), then a warm run; their
SAMs must be byte-equal.  Each prints the JAX tool's dict (unrounded) with
"device" and "peak_device_gb" (bench_longtarget.one_run).

    python tools/make_data.py bench_data
    python -m ssw_tpu_torch.tools.bench_iontorrent [--device cpu]

On the card unless --device cpu (the plain versions; slow at this size).
"""

from __future__ import annotations

import argparse
import os
import sys

from ssw_tpu_torch.tools.bench_longtarget import REPO
from ssw_tpu_torch.tools.bench_longtarget import one_run as _one_run

N_READS = 1000
TARGET = os.path.join(REPO, "bench_data", "ecoli_synth.fa")
READS = os.path.join(REPO, "bench_data", "iontorrent_1k.fastq")


def one_run(label, target=TARGET, reads=READS, device=None,
            n_reads=N_READS):
    """cli.main(["-c", "-s", "-h", target, reads]); returns (dict, SAM)."""
    return _one_run(label, ["-c", "-s", "-h", target, reads], n_reads,
                    device)


def run(target=TARGET, reads=READS, device=None, n_reads=N_READS):
    """Cold, then warm; asserts the SAMs byte-equal.  Returns ([cold dict,
    warm dict], the SAM text)."""
    cold, sam_cold = one_run("cold", target, reads, device, n_reads)
    warm, sam_warm = one_run("warm", target, reads, device, n_reads)
    assert sam_cold == sam_warm, "the cold and warm SAMs differ"
    return [cold, warm], sam_cold


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.bench_iontorrent")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    runs, _ = run(device=args.device)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
