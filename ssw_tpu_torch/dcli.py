"""Distributed/batch CLI: `ssw_test` semantics scaled over hosts and cards.

The reference CLI is single-threaded (ref: src/main.c:462); this command is
the scale-out entry point for the large configs (BASELINE.json configs 4-5),
the PyTorch counterpart of the JAX package's dcli.py:

  align mode
    python -m ssw_tpu_torch.dcli align [ssw_test options] \
        [--num-hosts N --host-id I --coordinator HOST:PORT] \
        [--batch-size B] [--mesh-seq S] [--journal PREFIX] \
        --out PREFIX  <target.fa> <query.fa|fq>

    Every host runs the same command with its own --host-id.  Reads are
    data-parallel across hosts (contiguous slice of every global batch —
    parallel/multihost.py); within a host the forward pass runs over a
    (data x seq) mesh of local devices when more than one is present
    (reads data-parallel, target sequence-parallel with halo re-compute —
    parallel/dist.py).  Each host writes PREFIX.part<I>; --journal makes
    the run resumable batch-by-batch.

  merge mode
    python -m ssw_tpu_torch.dcli merge --out FILE PREFIX.part0 ...

    Re-assembles shards into the exact read-major order `ssw_test` emits
    (byte-identical to a single-process ssw_tpu_torch.cli run, incl. the
    SAM header when -s -h -c were used).

Output parity: the shard lines are rendered by the same code path as
ssw_tpu_torch.cli (cli.render_batch), so `align`+`merge` output == `cli`
output.

Local devices: every CUDA device of the host (main() raises without a
card), or `devices=` (main's argument: the tests pass [cpu] * 8, and
chip_smoke.py [cuda:0] * 4 to run the sequence shards on one card), or
[device] with device= alone.  With --coordinator the hosts join a gloo
process group (parallel/multihost.py), left again before main returns.

Spans (profiling): `dcli.align`, the root of an align run (target parse,
reads, every batch), and `dcli.merge`, the root of a merge.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from ssw_tpu_torch import cli as cli_mod
from ssw_tpu_torch import pipeline, profiling
from ssw_tpu_torch.core.encoding import (AA_TABLE, BLOSUM50, NT_TABLE,
                                         dna_matrix, encode_with_table,
                                         parse_matrix_file,
                                         reverse_complement)
from ssw_tpu_torch.io.fastx import (read_fastx_auto as read_fastx,
                                    read_fastx_all)
from ssw_tpu_torch.parallel import multihost


def _build_parser():
    p = argparse.ArgumentParser(prog="ssw_tpu_torch.dcli")
    sub = p.add_subparsers(dest="mode", required=True)
    a = sub.add_parser("align")
    a.add_argument("-m", type=int, default=2, dest="match")
    a.add_argument("-x", type=int, default=2, dest="mismatch")
    a.add_argument("-o", type=int, default=3, dest="gap_open")
    a.add_argument("-e", type=int, default=1, dest="gap_extension")
    a.add_argument("-p", action="store_true", dest="protein")
    a.add_argument("-a", default=None, dest="mat_file")
    a.add_argument("-c", action="store_true", dest="path")
    a.add_argument("-f", type=int, default=0, dest="filter")
    a.add_argument("-r", action="store_true", dest="reverse")
    a.add_argument("-s", action="store_true", dest="sam")
    a.add_argument("--header", action="store_true", dest="header")
    a.add_argument("--num-hosts", type=int, default=1)
    a.add_argument("--host-id", type=int, default=0)
    a.add_argument("--coordinator", default=None)
    a.add_argument("--batch-size", type=int, default=2048)
    a.add_argument("--mesh-seq", type=int, default=1,
                   help="sequence-parallel factor over local devices")
    a.add_argument("--profile", action="store_true",
                   help="per-phase GCUPS report on stderr at exit")
    a.add_argument("--journal", default=None,
                   help="journal path prefix (enables resume)")
    a.add_argument("--out", required=True, help="shard path prefix")
    a.add_argument("target")
    a.add_argument("query")
    m = sub.add_parser("merge")
    m.add_argument("--out", required=True)
    m.add_argument("shards", nargs="+")
    return p


def _setup_matrix(args, err):
    table, n = NT_TABLE, 5
    mat = dna_matrix(args.match, args.mismatch)
    if args.protein and args.mat_file is None:
        n, table, mat = 24, AA_TABLE, BLOSUM50
    elif args.mat_file is not None:
        mat, table = parse_matrix_file(args.mat_file)
        n = mat.shape[0]
    return mat, table, n


def _local_devices(device, devices) -> list:
    """The host's devices: `devices`, else [device], else every CUDA device
    (raises without a card)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device is not None:
        return [pipeline.resolve_device(device)]
    pipeline.resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(argv=None, out=None, err=None, device=None, devices=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = out or sys.stdout
    err = err or sys.stderr
    args = _build_parser().parse_args(argv)

    if args.mode == "merge":
        with profiling.span("dcli.merge"), open(args.out, "w") as f:
            n = multihost.merge_shards(args.shards, f)
        err.write(f"merged {n} records into {args.out}\n")
        return 0

    for path in (args.target, args.query):
        if not os.path.exists(path):
            # same clean failure as cli.py (the reference segfaults on an
            # unchecked gzopen, ref: src/main.c:436)
            err.write(f"Failed to open the file {path}.\n")
            return 1

    local = _local_devices(device, devices)
    if args.coordinator:
        # the gloo rendezvous of every host; without a coordinator the
        # hosts still shard reads independently
        multihost.init_distributed(args.coordinator, args.num_hosts,
                                   args.host_id)
    ok = False
    try:
        rc = _align(args, out, err, local)
        ok = True
        return rc
    finally:
        multihost.shutdown_distributed(ok)


def _align(args, out, err, local) -> int:
    # --profile or SSW_TPU_PROFILE=1: the report line at exit;
    # SSW_TPU_TRACE=<dir>: a torch.profiler trace with the spans on it
    trace_dir = os.environ.get("SSW_TPU_TRACE")
    report = args.profile or bool(os.environ.get("SSW_TPU_PROFILE"))
    counter = profiling.GcupsCounter() if report or trace_dir else None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as ctx:
        if counter is not None:
            ctx.enter_context(pipeline.profiled(counter))
            ctx.enter_context(profiling.trace(trace_dir))
        ctx.enter_context(profiling.span("dcli.align"))
        rc, n_done, shard_path = _align_run(args, err, local)
    if rc:
        return rc
    dt = time.perf_counter() - t0
    err.write(f"host {args.host_id}/{args.num_hosts}: {n_done} reads in "
              f"{dt:.3f}s ({n_done / dt if dt else 0:.1f} reads/s) -> "
              f"{shard_path}\n")
    if report:
        err.write(counter.report() + "\n")
    return 0


def _align_run(args, err, local):
    """The align mode's work: (return code, reads written, shard path)."""
    mat, table, n = _setup_matrix(args, err)
    sam = args.sam
    opts = dict(match=args.match, mismatch=args.mismatch,
                gap_open=args.gap_open, gap_extension=args.gap_extension,
                filter=args.filter, protein=args.protein, path=args.path,
                reverse=args.reverse, sam=sam, header=args.header,
                mat_file=args.mat_file)

    if args.reverse and n == 24:
        # reference/cli parity (ref: src/main.c:482-491)
        err.write("Reverse complement alignment is not available for "
                  "protein sequences. \n")
        return 1, 0, None

    targets = read_fastx_all(args.target)
    enc_targets = [encode_with_table(t.seq, table) for t in targets]
    rc_allowed = args.reverse and n == 5
    flag = 2 if args.path else 0

    if sam and not args.path:
        err.write("SAM format output is only available together with "
                  "option -c.\n")
        sam = False

    mesh = None
    if len(local) > 1:
        from ssw_tpu_torch.parallel import mesh as mesh_lib
        seq = max(1, min(args.mesh_seq, len(local)))
        # LOCAL devices only: hosts split reads via ShardPlan (no cross-host
        # device traffic), so each host meshes its own cards
        mesh = mesh_lib.make_mesh(data=len(local) // seq, seq=seq,
                                  devices=local)

    def entry_of(rec):
        e = {"rec": rec, "num": encode_with_table(rec.seq, table)}
        if rc_allowed:
            e["rc"] = reverse_complement(rec.seq)
            e["num_rc"] = encode_with_table(e["rc"], table)
        return e

    def align_fn(owned_records):
        batch = [entry_of(r) for r in owned_records]
        return cli_mod.render_batch(batch, targets, enc_targets, mat, opts,
                                    table, sam, args.filter, flag,
                                    rc_allowed, err, mesh=mesh,
                                    device=local[0])

    plan = multihost.ShardPlan(num_hosts=args.num_hosts,
                               host_id=args.host_id,
                               batch_size=args.batch_size)
    shard_path = f"{args.out}.part{args.host_id}"
    journal = (f"{args.journal}.journal{args.host_id}"
               if args.journal else None)

    # the SAM header is emitted once, by host 0, as shard entry index -1
    header_text = ""
    if sam and args.header and args.path and args.host_id == 0:
        lines = ["@HD\tVN:1.4\tSO:queryname\n"]
        lines += [f"@SQ\tSN:{t.name}\tLN:{len(t.seq)}\n" for t in targets]
        header_text = "".join(lines)

    records = read_fastx(args.query)
    n_done = multihost.run_sharded(records, plan, align_fn, shard_path,
                                   journal, header=header_text or None)
    return 0, n_done, shard_path


if __name__ == "__main__":
    sys.exit(main())
