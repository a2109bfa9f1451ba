"""The port's distributed CLI (ssw_tpu_torch.dcli) and its multi-host
layer (ssw_tpu_torch.parallel.multihost) on the CPU.

N host runs of `dcli align` + `dcli merge` must be byte-identical to the
JAX package's single-process cli.main: two hosts in one process, a host
whose devices form a (data x seq) mesh ([cpu] * 8, --mesh-seq 2), a resumed
run, and two real processes joined by a gloo rendezvous (--coordinator).
The multi-host layer's ShardPlan/Journal/run_sharded/merge_shards cases are those of
tests/test_multihost.py, run on the port's copies."""

import io
import os
import socket
import subprocess
import sys

import pytest
import torch

from ssw_tpu import cli as jax_cli
from ssw_tpu_torch import dcli
from ssw_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP here runs small tensors, on which torch's thread pool
    gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single(args):
    out, err = io.StringIO(), io.StringIO()
    assert jax_cli.main(args, out=out, err=err) == 0
    return out.getvalue()


def _dcli(args, **kw):
    out, err = io.StringIO(), io.StringIO()
    assert dcli.main(args, out=out, err=err, **kw) == 0
    return err.getvalue()


def _merge(tmp_path, shards):
    merged = str(tmp_path / "merged.txt")
    _dcli(["merge", "--out", merged, *shards])
    with open(merged) as f:
        return f.read()


def test_two_host_sam_matches_single(tmp_path):
    target = os.path.join(DATA, "1k.fa")
    query = os.path.join(DATA, "54mer_hap1_1.100.fastq")
    want = _single(["-c", "-s", "-h", "-r", target, query])
    prefix = str(tmp_path / "run")
    for host in range(2):
        _dcli(["align", "-c", "-s", "--header", "-r",
               "--num-hosts", "2", "--host-id", str(host),
               "--batch-size", "32", "--out", prefix,
               "--journal", prefix, target, query], device="cpu")
    assert _merge(tmp_path, [f"{prefix}.part0", f"{prefix}.part1"]) == want


def test_mesh_sharded_host_matches_single(tmp_path):
    """BASELINE config 5's route at a small size: a host with eight local
    devices runs the forward pass over a 4 x 2 (data x seq) mesh
    (align_batch_sharded, target sharding + halo); the merged output stays
    byte-identical to the single-process CLI."""
    target = os.path.join(DATA, "1k.fa")
    query = os.path.join(DATA, "54mer_hap1_1.100.fastq")
    want = _single(["-c", "-s", "-h", target, query])
    prefix = str(tmp_path / "m")
    _dcli(["align", "-c", "-s", "--header", "--num-hosts", "1",
           "--host-id", "0", "--batch-size", "64", "--mesh-seq", "2",
           "--out", prefix, target, query], devices=[CPU] * 8)
    assert _merge(tmp_path, [f"{prefix}.part0"]) == want


def test_resume_after_partial_run(tmp_path):
    target = os.path.join(DATA, "1k.fa")
    query = os.path.join(DATA, "54mer_hap1_1.100.fastq")
    want = _single(["-c", target, query])
    prefix = str(tmp_path / "r")
    args = ["align", "-c", "--num-hosts", "1", "--host-id", "0",
            "--batch-size", "40", "--out", prefix, "--journal", prefix,
            target, query]
    _dcli(args, device="cpu")
    before = open(f"{prefix}.part0").read()
    # a re-run with the journal present does nothing and keeps the shard
    assert "0 reads" in _dcli(args, device="cpu")
    assert open(f"{prefix}.part0").read() == before
    assert _merge(tmp_path, [f"{prefix}.part0"]) == want


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


RUNNER = """
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from ssw_tpu_torch import dcli
from ssw_tpu_torch.parallel import multihost
seen = []
join = multihost.init_distributed
multihost.init_distributed = lambda *a: seen.append(join(*a)) or seen[-1]
rc = dcli.main({args!r}, device="cpu")
assert seen == [({host}, 2)], seen
assert not dist.is_initialized()
sys.exit(rc)
"""


def test_two_process_gloo_align(tmp_path):
    """Two `dcli align --coordinator` processes meet in a gloo process
    group (multihost.init_distributed), align their halves and leave the
    group; the merged shards equal the single-process CLI's output."""
    target = os.path.join(DATA, "1k.fa")
    query = os.path.join(DATA, "54mer_hap1_1.100.fastq")
    coord = f"127.0.0.1:{_free_port()}"
    prefix = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    for host in (0, 1):
        args = ["align", "-c", "-s", "--header", "--coordinator", coord,
                "--num-hosts", "2", "--host-id", str(host),
                "--batch-size", "32", "--out", prefix, target, query]
        code = RUNNER.format(repo=REPO, args=args, host=host)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, _, err in outs:
        assert rc == 0, err[-2000:]
    want = _single(["-c", "-s", "-h", target, query])
    assert _merge(tmp_path, [f"{prefix}.part0", f"{prefix}.part1"]) == want


def test_align_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dcli.main(["align", "--out", str(tmp_path / "x"),
                   os.path.join(DATA, "1k.fa"),
                   os.path.join(DATA, "test.seq")],
                  out=io.StringIO(), err=io.StringIO())


# -- the multi-host layer (tests/test_multihost.py's cases) ----------------

def test_owned_ranges_cover_and_balance():
    plan = [multihost.ShardPlan(num_hosts=3, host_id=p) for p in range(3)]
    for blen in (1, 2, 3, 7, 2048):
        ranges = [pl.owned_range(blen) for pl in plan]
        assert ranges[0][0] == 0 and ranges[-1][1] == blen
        for (a, b), (c, d) in zip(ranges, ranges[1:]):
            assert b == c
        sizes = [b - a for a, b in ranges]
        assert max(sizes) - min(sizes) <= 1


def test_batches_split_and_offsets():
    out = {}
    for p in range(2):
        plan = multihost.ShardPlan(num_hosts=2, host_id=p, batch_size=4)
        for g, off, owned in plan.batches(range(10)):
            for i, r in enumerate(owned):
                out[off + i] = r
    assert out == {i: i for i in range(10)}


def test_run_sharded_and_merge(tmp_path):
    recs = [f"read{i}" for i in range(9)]
    shards = []
    for p in range(2):
        plan = multihost.ShardPlan(num_hosts=2, host_id=p, batch_size=4)
        shard = str(tmp_path / f"out.part{p}")
        assert multihost.run_sharded(
            recs, plan, lambda owned: [r.upper() + "\n" for r in owned],
            shard, journal_path=str(tmp_path / f"journal{p}")) > 0
        shards.append(shard)
    buf = io.StringIO()
    assert multihost.merge_shards(shards, buf) == 9
    assert buf.getvalue() == "".join(f"READ{i}\n" for i in range(9))


def test_resume_skips_completed_batches(tmp_path):
    recs = [f"r{i}" for i in range(8)]
    plan = multihost.ShardPlan(num_hosts=1, host_id=0, batch_size=4)
    shard, journal = str(tmp_path / "s"), str(tmp_path / "j")
    calls = []

    def align(owned):
        calls.append(len(owned))
        if len(calls) == 2:
            raise RuntimeError("simulated crash in batch 2")
        return [r + "\n" for r in owned]

    with pytest.raises(RuntimeError):
        multihost.run_sharded(recs, plan, align, shard, journal)
    assert calls == [4, 4]
    calls.clear()
    n = multihost.run_sharded(
        recs, plan, lambda o: calls.append(len(o)) or [r + "\n" for r in o],
        shard, journal)
    assert calls == [4] and n == 4  # batch 0 skipped, only batch 1 re-run
    buf = io.StringIO()
    assert multihost.merge_shards([shard], buf) == 8
    assert buf.getvalue() == "".join(f"r{i}\n" for i in range(8))


def test_crash_between_write_and_journal_no_duplicates(tmp_path,
                                                       monkeypatch):
    recs = [f"r{i}" for i in range(8)]
    plan = multihost.ShardPlan(num_hosts=1, host_id=0, batch_size=4)
    shard, journal = str(tmp_path / "s"), str(tmp_path / "j")
    real_mark = multihost.Journal.mark

    def crashing_mark(self, batch, n):
        if batch == 1:
            raise RuntimeError("simulated crash after write, before mark")
        return real_mark(self, batch, n)

    monkeypatch.setattr(multihost.Journal, "mark", crashing_mark)
    with pytest.raises(RuntimeError):
        multihost.run_sharded(recs, plan, lambda o: [r + "\n" for r in o],
                              shard, journal)
    monkeypatch.setattr(multihost.Journal, "mark", real_mark)
    multihost.run_sharded(recs, plan, lambda o: [r + "\n" for r in o],
                          shard, journal)
    buf = io.StringIO()
    assert multihost.merge_shards([shard], buf) == 8
    assert buf.getvalue() == "".join(f"r{i}\n" for i in range(8))


def test_empty_line_suppression(tmp_path):
    plan = multihost.ShardPlan(num_hosts=1, host_id=0, batch_size=8)
    shard = str(tmp_path / "s")
    multihost.run_sharded(["a", "b"], plan, lambda o: ["A\n", ""], shard)
    buf = io.StringIO()
    assert multihost.merge_shards([shard], buf) == 2
    assert buf.getvalue() == "A\n"


def test_truncated_shard_line_on_resume(tmp_path):
    recs = [f"r{i}" for i in range(8)]
    plan = multihost.ShardPlan(num_hosts=1, host_id=0, batch_size=4)
    shard, journal = str(tmp_path / "s"), str(tmp_path / "j")
    multihost.run_sharded(recs[:4], plan, lambda o: [r + "\n" for r in o],
                          shard, journal_path=journal)
    with open(shard, "a") as f:
        f.write('{"i": 4, "s": "r4')  # truncated, no newline
    multihost.run_sharded(recs, plan, lambda o: [r + "\n" for r in o],
                          shard, journal_path=journal)
    buf = io.StringIO()
    assert multihost.merge_shards([shard], buf) == 8
    assert buf.getvalue() == "".join(f"r{i}\n" for i in range(8))


def test_init_distributed_is_a_no_op_for_one_process():
    assert multihost.init_distributed(None, 1, 0) == (0, 1)
    assert multihost.init_distributed() == (0, 1)
    multihost.shutdown_distributed()
