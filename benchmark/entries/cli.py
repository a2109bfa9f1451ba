"""Back-to-back ssw_tpu_torch.cli.main calls (the ssw_test batch run),
each over one FASTQ of a pool written from the seed during set-up: chunk
0 warms up, the window cycles through chunks 1..pool_calls.  SAM goes to
an in-memory sink.  Compared by compare/cli.py."""

import io
import os
import time
import traceback

from benchmark import gen, opcount
from benchmark.harness import sync
from benchmark.plugins import make_target, plugin, sample_reads


class Driver:
    def __init__(self, cfg, traffic, seed, device, tmp):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.target = make_target(cfg, tmp)
        n = cfg["reads_per_call"]
        gz = cfg["query_format"] == "fastq.gz"
        self.pool, self.paths = [], []
        for c in range(traffic["pool_calls"] + 1):
            recs = sample_reads(cfg, self.target, n,
                                gen.rng_for(seed, 1, c), first=c * n)
            path = os.path.join(tmp, f"reads_{c}.fastq" + (".gz" if gz
                                                            else ""))
            gen.write_fastq(path, recs, gz)
            self.pool.append(recs)
            self.paths.append(path)
        self.calls = []

    def call(self, chunk: int) -> dict:
        from ssw_tpu_torch import cli

        out, err = io.StringIO(), io.StringIO()
        argv = list(self.cfg["cli_flags"]) + [self.target["path"],
                                              self.paths[chunk]]
        try:
            ok = cli.main(argv, out=out, err=err, device=self.device) == 0
        except Exception:
            traceback.print_exc()
            ok = False
        sync(self.device)
        return dict(chunk=chunk, ok=ok, sam=out.getvalue())

    def warm_up(self):
        self.call(0)

    def run(self, seconds: float, t0: float, span):
        P = self.traffic["pool_calls"]
        k = 0
        while k == 0 or time.perf_counter() - t0 < seconds:
            s = time.perf_counter()
            with span():
                rec = self.call(1 + k % P)
            rec["t"] = (s, time.perf_counter())
            self.calls.append(rec)
            k += 1

    def records(self, call: dict) -> list:
        return self.pool[call["chunk"]]

    def attempted(self) -> int:
        return sum(len(self.records(c)) for c in self.calls)

    def failed(self) -> int:
        return sum(len(self.records(c)) for c in self.calls if not c["ok"])

    def forward_cells(self) -> int:
        strands = 2 if plugin("compare", "cli").cli_opts(
            self.cfg)["reverse"] else 1
        return sum(opcount.forward_cells(
            [len(s) for _, s, _ in self.records(c)],
            len(self.target["seq"]), strands) for c in self.calls)

    def latencies(self):
        return None

    def extra(self) -> dict:
        return {"call_seconds": [c["t"][1] - c["t"][0] for c in self.calls]}

    def free(self):
        pass
