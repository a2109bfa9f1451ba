"""Back-to-back ssw_tpu_torch.api.Aligner().align(read, window) calls (one
read against the reference window that holds its origin, per call).  Call
k's read has origin order[k], a seeded permutation of the N-free read
starts, so no (read, window) pair repeats.  Compared by
compare/aligner.py."""

import time
import traceback

from benchmark import gen, opcount
from benchmark.harness import sync
from benchmark.plugins import make_target


class Driver:
    def __init__(self, cfg, traffic, seed, device, tmp):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.target = make_target(cfg, tmp)
        rd = cfg["reads"]
        if "read_len" not in rd:
            raise ValueError("the aligner traffic samples fixed-length reads")
        self.read_len, self.err = rd["read_len"], rd["err"]
        self.order = gen.rng_for(seed, 3).permutation(
            gen.read_start_positions(self.target["seq"], self.read_len))
        self.blocks = {}
        self.next = 0
        self.calls = []
        self.lat = []
        self.aligner = None

    def strings(self, k: int):
        """Call k's read (uint8 array), window start, and both as text."""
        read, start = self.pair(k)
        w = self.traffic["window"]
        return (read, start, read.tobytes().decode("ascii"),
                self.target["seq"][start:start + w].decode("latin-1"))

    def pair(self, k: int):
        B = self.traffic["block"]
        b, i = divmod(k % len(self.order), B)
        if b not in self.blocks:
            self.blocks = {b: gen.local_pairs(
                self.target["seq"], self.order, b * B, B,
                gen.rng_for(self.seed, 2, b), self.read_len, self.err,
                self.traffic["window"])}
        reads, starts = self.blocks[b]
        return reads[i], int(starts[i])

    def call(self, k: int, timed: bool):
        read, start, q, t = self.strings(k)
        ml = max(15, len(q) // 2)
        s = time.perf_counter()
        ok, fields = True, None
        try:
            flag, a = self.aligner.align(q, t, mask_len=ml)
            fields = (a.sw_score, a.sw_score_next_best, a.ref_begin,
                      a.ref_end, a.query_begin, a.query_end,
                      a.ref_end_next_best, a.mismatches, a.cigar_string,
                      flag)
        except Exception:
            traceback.print_exc()
            ok = False
        sync(self.device)
        e = time.perf_counter()
        if timed:
            self.calls.append(dict(read=read, start=start, ok=ok,
                                   fields=fields))
            self.lat.append(e - s)

    def warm_up(self):
        from ssw_tpu_torch import api

        sc = self.cfg["scoring"]
        self.aligner = api.Aligner(sc["match"], sc["mismatch"],
                                   sc["gap_open"], sc["gap_extension"],
                                   device=self.device)
        for _ in range(self.traffic["warmup_calls"]):
            self.call(self.next, False)
            self.next += 1

    def run(self, seconds: float, t0: float, span):
        k = 0
        while k == 0 or time.perf_counter() - t0 < seconds:
            with span():
                self.call(self.next, True)
            self.next += 1
            k += 1

    def attempted(self) -> int:
        return len(self.calls)

    def failed(self) -> int:
        return sum(not c["ok"] for c in self.calls)

    def forward_cells(self) -> int:
        return opcount.forward_cells([self.read_len] * len(self.calls),
                                     self.traffic["window"], 1)

    def latencies(self):
        return self.lat

    def extra(self) -> dict:
        return {}

    def free(self):
        self.aligner = None
