"""The comparison of the aligner entry: the C++ Aligner's answer for each
sampled call, worked out again by the plain reference.  Nothing of the
program is imported.  Exact (limit 0): `calls_failed` (calls that
raised), `alignments_differing` (of `check_calls` calls drawn from the
seed, those whose ten Alignment fields or accuracy flag differ)."""

from __future__ import annotations

import numpy as np

from benchmark import check, gen
from benchmark import reference as R


def aligner_fields(cfg, traffic, genome: bytes, reads, starts, device,
                   sat=None, timings=None) -> list[tuple]:
    """The C++ Aligner's answer (default 5x5 matrix with N scoring
    -mismatch, flag 0x0F, distance filter 32767) for each read against
    the window of the genome at its start."""
    sc, w = cfg["scoring"], traffic["window"]
    mat = R.cpp_matrix(sc["match"], sc["mismatch"])
    q = [R.encode(r.tobytes(), R.CPP_TABLE) for r in reads]
    t = [R.encode(genome[s:s + w], R.CPP_TABLE) for s in starts]
    res = R.align_many(q, t, mat, sc["gap_open"], sc["gap_extension"],
                       flag=0x0F, filters=0, filterd=32767,
                       mask_len=np.array([max(15, len(r) // 2) for r in q]),
                       device=device, sat=sat, timings=timings)
    return [R.aligner_fields(a, tt, qq) for a, tt, qq in zip(res, t, q)]


def sample(driver) -> list:
    n = min(driver.traffic["check_calls"], len(driver.calls))
    return sorted(gen.rng_for(driver.seed, 5).choice(len(driver.calls), n,
                                                    replace=False))


def compare(driver, device, sat=None, timings=None) -> dict:
    calls = driver.calls
    pick = sample(driver)
    want = aligner_fields(driver.cfg, driver.traffic, driver.target["seq"],
                          [calls[k]["read"] for k in pick],
                          [calls[k]["start"] for k in pick], device, sat,
                          timings)
    differ = sum(calls[k]["fields"] != w for k, w in zip(pick, want))
    return {"calls_failed": check.count(sum(not c["ok"] for c in calls)),
            "alignments_differing": check.count(differ, len(pick))}


def plant_control(driver, calls: int, device, sat) -> None:
    """The window taken to hold `calls` calls whose sampled answers are
    the reference's at precision `sat`."""
    driver.calls = []
    for k in range(calls):
        read, start, _, _ = driver.strings(k)
        driver.calls.append(dict(read=read, start=start, ok=True,
                                 fields=None))
    pick = sample(driver)
    got = aligner_fields(driver.cfg, driver.traffic, driver.target["seq"],
                         [driver.calls[k]["read"] for k in pick],
                         [driver.calls[k]["start"] for k in pick], device,
                         sat=sat)
    for k, f in zip(pick, got):
        driver.calls[k]["fields"] = f
