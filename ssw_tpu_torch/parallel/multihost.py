"""Multi-host scale-out: data-parallel FASTQ sharding across hosts,
deterministic output order, and checkpoint/resume journaling.

The reference has no multi-process story at all (single thread, one read at
a time, ref: src/main.c:462); this is the JAX package's design
(ssw_tpu/parallel/multihost.py), with torch.distributed in place of
jax.distributed:

  * each host parses the *same* FASTQ stream but keeps only its contiguous
    slice of every global batch (zero coordination; deterministic);
  * per-host SAM/BLAST shards carry the global read index so the final
    output is the exact read-major order `ssw_test` emits (SAM
    `SO:queryname` with input order, ref: src/main.c:443);
  * a journal line per completed batch makes huge runs resumable;
  * init_distributed joins the hosts in one gloo process group.  As in the
    JAX design nothing but that rendezvous crosses hosts: each host meshes
    its own devices (dcli.py).  gloo, not NCCL: the group carries no
    device traffic, and NCCL cannot put two ranks on one card.

ShardPlan, Journal, run_sharded and merge_shards are copies of the JAX
package's (which import no JAX).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Sequence


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the gloo process group at tcp://coordinator_address when a
    multi-process run is requested (no-op for one process); blocks until
    every rank has arrived.  Returns (process_id, num_processes)."""
    import torch.distributed as dist

    if num_processes is not None and num_processes > 1 \
            and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_distributed(ok: bool = True):
    """Leave the process group, if one was joined: on success after a
    barrier (every rank has finished its shard), else at once."""
    import torch.distributed as dist

    if dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()


@dataclass
class ShardPlan:
    """Deterministic partition of a read stream over hosts.

    Every host sees the same stream; global batch g covers reads
    [g*batch, (g+1)*batch); host p owns the contiguous sub-slice computed
    by `owned_range`.  Contiguity keeps output re-assembly a concatenation.
    """
    num_hosts: int
    host_id: int
    batch_size: int = 2048

    def owned_range(self, batch_len: int) -> tuple[int, int]:
        """Sub-range of a batch owned by this host (balanced contiguous
        split; first `rem` hosts get one extra read)."""
        per, rem = divmod(batch_len, self.num_hosts)
        lo = self.host_id * per + min(self.host_id, rem)
        hi = lo + per + (1 if self.host_id < rem else 0)
        return lo, hi

    def batches(self, records: Iterable) -> Iterator[tuple[int, int, list]]:
        """Yield (batch_index, global_offset_of_owned_slice, owned_records)."""
        buf: list = []
        g = 0
        base = 0
        for rec in records:
            buf.append(rec)
            if len(buf) == self.batch_size:
                lo, hi = self.owned_range(len(buf))
                yield g, base + lo, buf[lo:hi]
                g += 1
                base += len(buf)
                buf = []
        if buf:
            lo, hi = self.owned_range(len(buf))
            yield g, base + lo, buf[lo:hi]


class Journal:
    """Append-only batch-completion journal for checkpoint/resume."""

    def __init__(self, path: str | None):
        self.path = path
        self.done: set[int] = set()
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        self.done.add(json.loads(line)["batch"])
                    except (ValueError, KeyError):
                        continue

    def is_done(self, batch: int) -> bool:
        return batch in self.done

    def mark(self, batch: int, n_reads: int):
        self.done.add(batch)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"batch": batch, "reads": n_reads}) + "\n")
                f.flush()
                os.fsync(f.fileno())


def run_sharded(records: Iterable, plan: ShardPlan,
                align_fn: Callable[[list], list[str]],
                shard_path: str, journal_path: str | None = None,
                header: str | None = None) -> int:
    """Drive a host's share of the stream: align owned slices batch by
    batch, write `(global_index, line)` pairs to the shard file, journal
    completion.  Returns the number of reads this host processed.

    align_fn: list of owned records -> list of output lines (one per record,
    "" for suppressed records).  header, if given, sorts before every read
    (global index -1) and is written on fresh runs only.
    """
    journal = Journal(journal_path)
    n_done = 0
    mode = "a" if journal.done else "w"
    needs_guard = False
    if mode == "a" and os.path.exists(shard_path) \
            and os.path.getsize(shard_path) > 0:
        # a run killed mid-write can leave the shard's last line truncated
        # with no trailing newline; a leading separator stops the first
        # re-appended record from concatenating onto it (the orphan
        # fragment is then skipped by merge_shards)
        with open(shard_path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            needs_guard = f.read(1) != b"\n"
    with open(shard_path, mode) as out:
        if needs_guard:
            out.write("\n")
        if header and mode == "w":
            out.write(json.dumps({"i": -1, "s": header}) + "\n")
        for g, offset, owned in plan.batches(records):
            if journal.is_done(g):
                continue
            lines = align_fn(owned)
            assert len(lines) == len(owned)
            for i, line in enumerate(lines):
                out.write(json.dumps({"i": offset + i, "s": line}) + "\n")
            out.flush()
            journal.mark(g, len(owned))
            n_done += len(owned)
    return n_done


def merge_shards(shard_paths: Sequence[str], out_stream) -> int:
    """Re-assemble per-host shard files into the global read order.
    Returns the number of records written.

    Deduplicates by global index keeping the LAST occurrence: a crash after
    a batch's lines were appended but before its journal mark makes the
    resumed run re-append that batch, and the re-run lines supersede the
    (possibly truncated) first write.  Unparseable lines (the truncated
    remnant of a mid-write crash) are skipped — the resumed run re-emitted
    every record the journal had not marked done."""
    latest: dict[int, str] = {}
    for p in shard_paths:
        with open(p) as f:
            for line in f:
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                latest[d["i"]] = d["s"]
    n = 0
    for i in sorted(latest):
        if latest[i]:
            out_stream.write(latest[i])
        n += 1
    return n
