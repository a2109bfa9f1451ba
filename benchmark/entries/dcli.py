"""Back-to-back ssw_tpu_torch.dcli runs, BASELINE config 5's scale-out
entry: per call `dcli align` over a 1 x mesh_seq (data x seq) mesh of the
host's cards cuda:0.. (the target split mesh_seq ways, reads not split),
then `dcli merge`, and the merged SAM read back from the run's temporary
directory.  On "cpu" the mesh is [cpu] * mesh_seq.  The pool, the window
and the counts are the cli entry's (entries/cli.py); compared by
compare/dcli.py.

The harness's `device` entry names one card, cuda:0.  This entry reports
in its place the cards the mesh ran on: their number, and the peak memory
of the fullest, with the traced window's busy_s and window_s as the
harness's summary gives them."""

import io
import os
import traceback

import torch

from benchmark import tracing
from benchmark.harness import sync
from benchmark.plugins import plugin

_cli = plugin("entries", "cli")


class Driver(_cli.Driver):
    def __init__(self, cfg, traffic, seed, device, tmp):
        super().__init__(cfg, traffic, seed, device, tmp)
        S = traffic["mesh_seq"]
        self.devices = ([torch.device("cpu")] * S if device.type == "cpu"
                        else [torch.device("cuda", i) for i in range(S)])
        self.prefix = os.path.join(tmp, "run")
        self.summary, self._summarize = None, None

    def cards(self) -> list:
        return sorted(set(self.devices), key=str)

    def warm_up(self):
        super().warm_up()
        for d in self.cards():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)

    def run(self, seconds: float, t0: float, span):
        # keep the traced window's summary for extra()'s device entry
        self._summarize = tracing.summarize

        def keep(prof, classes):
            self.summary = self._summarize(prof, classes)
            return self.summary
        tracing.summarize = keep
        super().run(seconds, t0, span)

    def extra(self) -> dict:
        cards = self.cards()
        on_card = cards[0].type == "cuda"
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(cards[0]) if on_card
               else "cpu",
               "count": len(cards),
               "memory_peak_bytes": max(
                   int(torch.cuda.max_memory_allocated(d)) for d in cards)
               if on_card else 0}
        if self.summary is not None:
            dev.update(busy_s=self.summary["busy_s"],
                       window_s=self.summary["window_s"])
        return dict(super().extra(), device=dev)

    def free(self):
        if self._summarize is not None:
            tracing.summarize, self._summarize = self._summarize, None
        super().free()

    def call(self, chunk: int) -> dict:
        from ssw_tpu_torch import dcli

        part, merged = self.prefix + ".part0", self.prefix + ".sam"
        flags = ["--header" if f == "-h" else f
                 for f in self.cfg["cli_flags"]]
        argv = ["align", *flags, "--mesh-seq", str(self.traffic["mesh_seq"]),
                "--batch-size", str(self.traffic["batch_reads"]), "--out",
                self.prefix, self.target["path"], self.paths[chunk]]
        sam = ""
        try:
            err = io.StringIO()
            ok = (dcli.main(argv, out=io.StringIO(), err=err,
                            devices=self.devices) == 0
                  and dcli.main(["merge", "--out", merged, part],
                                out=io.StringIO(), err=err) == 0)
            if ok:
                with open(merged) as f:
                    sam = f.read()
        except Exception:
            traceback.print_exc()
            ok = False
        sync(self.device)
        for p in (part, merged):
            if os.path.exists(p):
                os.remove(p)
        return dict(chunk=chunk, ok=ok, sam=sam)
