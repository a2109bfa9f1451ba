"""The comparison of the cli entry: what ssw_test writes for the reads
the window's calls were given, worked out again by the plain reference.
Nothing of the program is imported.  Every check is exact (limit 0):

  * `calls_failed`: calls that raised or returned non-zero;
  * `records_wrong`: per call, a header other than ssw_test's, and
    records missing, extra or out of input order (every call, every
    record's name);
  * `sam_lines_differing`: sampled reads whose SAM record is not the
    reference's, byte for byte.  The sample is drawn from the seed:
    `check_per_call` reads of each call, spread systematically over the
    call's reads ordered by CLI batch (`batch_reads`) and length, so that
    every batch, and every length within it, of every call is hit; and the
    window's longest read.
"""

from __future__ import annotations

import numpy as np

from benchmark import check, gen
from benchmark import reference as R
from benchmark.plugins import scoring


def cli_opts(cfg) -> dict:
    flags = "".join(f.lstrip("-") for f in cfg["cli_flags"])
    return dict(reverse="r" in flags, sam="s" in flags, path="c" in flags,
                header="h" in flags)


def sam_lines(cfg, target, records, device, sat=None,
              timings=None) -> list:
    """The SAM record ssw_test writes for each (name, seq, qual) read
    against the target under the configuration's flags (-c -s, -r).  Both
    strands are aligned to their begins; the CIGAR is traced for the
    strand whose record is written (ssw_test traces both and prints one)."""
    sc, opts = cfg["scoring"], cli_opts(cfg)
    scm = scoring(cfg)
    mat = scm.matrix(sc)
    codes = target.get("codes")
    if codes is None:
        codes = target["codes"] = R.encode(target["seq"], scm.TABLE)
    reads = [R.encode(s, scm.TABLE) for _, s, _ in records]
    kw = dict(flag=2 if opts["path"] else 0, filters=0, filterd=0,
              mask_len=np.array([len(r) // 2 for r in reads]), device=device,
              sat=sat, timings=timings, paths=False)
    g = (sc["gap_open"], sc["gap_extension"])
    fwd = R.align_many(reads, codes, mat, *g, **kw)
    rc_reads = rc = [None] * len(reads)
    if opts["reverse"]:
        rc_reads = [R.encode(R.reverse_complement(s), scm.TABLE)
                    for _, s, _ in records]
        rc = R.align_many(rc_reads, codes, mat, *g, **kw)
    wins = [r is not None and r.score1 > f.score1 for f, r in zip(fwd, rc)]
    R.add_paths([r if w else f for f, r, w in zip(fwd, rc, wins)],
                [q if w else p for p, q, w in zip(reads, rc_reads, wins)],
                [codes] * len(reads), mat, *g, flag=kw["flag"], filters=0,
                filterd=0, timings=timings)
    return [R.cli_sam_line(f, r if w else None, target["name"], codes,
                           n.decode("latin-1"), s,
                           None if q is None else q.decode("latin-1"))
            for (n, s, q), f, r, w in zip(records, fwd, rc, wins)]


def header_lines(cfg, target) -> list[str]:
    opts = cli_opts(cfg)
    if not (opts["sam"] and opts["header"] and opts["path"]):
        return []
    return ["@HD\tVN:1.4\tSO:queryname",
            f"@SQ\tSN:{target['name']}\tLN:{len(target['seq'])}"]


def split_sam(text: str):
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    head = [ln for ln in lines if ln.startswith("@")]
    return head, [ln for ln in lines if not ln.startswith("@")]


def sample(driver) -> list:
    """(call, read) pairs to compare in full, drawn from the seed."""
    rng = gen.rng_for(driver.seed, 5)
    per, batch = driver.traffic["check_per_call"], \
        driver.traffic["batch_reads"]
    pick, pairs = [], []
    for k, call in enumerate(driver.calls):
        recs = driver.records(call)
        order = sorted(range(len(recs)),
                       key=lambda i: (i // batch, len(recs[i][1]), i))
        step = len(order) / min(per, len(order))
        off = rng.random()
        pick += [(k, order[int((off + j) * step)])
                 for j in range(min(per, len(order)))]
        pairs += [(k, i) for i in range(len(recs))]
    if pairs:
        longest = max(pairs, key=lambda p: len(
            driver.records(driver.calls[p[0]])[p[1]][1]))
        if longest not in pick:
            pick.append(longest)
    return pick


def compare(driver, device, sat=None, timings=None) -> dict:
    cfg, target, calls = driver.cfg, driver.target, driver.calls
    want_head = header_lines(cfg, target)
    failed = wrong = 0
    recs_of = {}
    for k, call in enumerate(calls):
        if not call["ok"]:
            failed += 1
            continue
        head, recs = split_sam(call["sam"])
        names = [n.decode("latin-1") for n, _, _ in driver.records(call)]
        got = [ln.split("\t", 1)[0] for ln in recs]
        wrong += int(head != want_head) + abs(len(got) - len(names))
        wrong += sum(a != b for a, b in zip(got, names))
        recs_of[k] = recs
    pick = sample(driver)
    keys = sorted({(calls[k]["chunk"], i) for k, i in pick})
    expect = dict(zip(keys, sam_lines(
        cfg, target, [driver.pool[c][i] for c, i in keys], device, sat,
        timings)))
    differ = 0
    for k, i in pick:
        recs = recs_of.get(k)
        line = expect[(calls[k]["chunk"], i)]
        got = recs[i] + "\n" if recs is not None and i < len(recs) else None
        differ += got != line
    return {"calls_failed": check.count(failed),
            "records_wrong": check.count(wrong),
            "sam_lines_differing": check.count(differ, len(pick))}


def plant_control(driver, calls: int, device, sat) -> None:
    """The window taken to hold `calls` whole calls (cycling through the
    pool) whose SAM is the control's: the sampled reads' records from the
    reference at precision `sat`, every other record its read's name."""
    P = driver.traffic["pool_calls"]
    driver.calls = [dict(chunk=1 + k % P, ok=True, sam=None)
                    for k in range(calls)]
    keys = sorted({(driver.calls[k]["chunk"], i) for k, i in sample(driver)})
    lines = dict(zip(keys, sam_lines(
        driver.cfg, driver.target, [driver.pool[c][i] for c, i in keys],
        device, sat=sat)))
    head = "".join(h + "\n" for h in header_lines(driver.cfg, driver.target))
    for c in driver.calls:
        recs = [lines.get((c["chunk"], i)) or n.decode("latin-1") + "\n"
                for i, (n, _, _) in enumerate(driver.pool[c["chunk"]])]
        c["sam"] = head + "".join(recs)
