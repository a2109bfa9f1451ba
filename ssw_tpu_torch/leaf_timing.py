"""Time the forward kernels on the config-4 leaf, in one or more trees, in
turns on one card.

    python3 -m ssw_tpu_torch.leaf_timing PARENT . . PARENT

The leaf: 1024 reads of 100 bp sampled (seed 1) from tests/data/1M.fa, L 128,
the target padded to 2^20 columns, DNA m2/x2/o3/e1.  For each tree given
(a checkout, e.g. a parent commit unpacked with `git archive`), in its own
process and in the order given, prints one JSON line of CUDA-event times in
ms: the int32 kernel with the quirk off and on, and the int16 tier, in base
mode and, where the tree has them, in blockmax mode, with the
bounded-radius gate, and in the owned-column mode (the leaf as shard 1 of a
seq split: 320 halo columns before the owned ones) beside the base mode;
the packed kernel on the same reads packed at 1024 lanes (blockmax mode,
the streaming leaf of config 4), and in dual mode on an Ion-like leaf
(1024 reads of 120-176 bp from the same genome, 1 % substitutions, the
L = 192 group's slots); where the tree has the column-scan bodies beside
the wavefront (scan_body=), those too, keyed `*_scan_body_ms`, and where
it has the int32 wavefront an int32 leaf like the Ion Torrent x20 one
(`ion_x20_int32_*`, blockmax and dual).  Trees without a mode time what
they have.  Needs a CUDA card.

    python3 -m ssw_tpu_torch.leaf_timing --ion [P ...]

times, in this tree alone, the packed forward launch of each leaf of the
reference README's Ion Torrent headline (1,000 reads of 25-540 bp against
4,938,920 bases, the default penalties) as the pipeline plans it, with the
target split into each P of stretches given (default 1 2 4 8 16 32) and at
the rule's P: one JSON line per leaf with its reads, lanes, the rule's P,
the integer-op bound (cuda_sw.packed_ops at 1.673e13 op/s) and ms per P.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np


def _time_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from ssw_tpu_torch.ops import _kernels, common, cuda_sw

    _kernels.build()
    with open(os.path.join(tree, "tests", "data", "1M.fa"), "rb") as f:
        seq = b"".join(ln.strip() for ln in f if not ln.startswith(b">"))
    table = np.full(256, 4, np.int8)
    for i, c in enumerate(b"ACGT"):
        table[c] = i
    codes = table[np.frombuffer(seq, np.uint8)]
    ref = np.full(1 << 20, 4, np.int32)
    ref[:len(codes)] = codes
    rng = np.random.default_rng(1)
    reads = [codes[s:s + 100].copy()
             for s in rng.integers(20000, len(codes) - 100, 1024)]
    rl = np.full(1024, 100, np.int32)
    mat = np.full((5, 5), -2, np.int8)
    np.fill_diagonal(mat, 2)
    mat[4, :] = mat[:, 4] = 0
    prof = common.build_profile(common.pad_reads(reads, 128, 4), rl,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(rl, 128, word=False)
    args = tuple(torch.as_tensor(np.ascontiguousarray(a)).cuda() for a in (
        prof, ref, rl, geo.col_mask, geo.seg_id, geo.seg_start)) + (3, 1)

    def ms(quirk, kw, reps=3, fn=None):
        def run():
            if fn is None:
                cuda_sw.forward_shared(*args, quirk, **kw)
            else:
                fn(quirk, kw)
        run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    res = {"tree": tree, "card": torch.cuda.get_device_name(0),
           "int32_ms": ms(False, {}), "int32_quirk_ms": ms(True, {}),
           "i16_ms": ms(False, {"max_sub": 2})}
    if "blockmax" in inspect.signature(cuda_sw.forward_shared).parameters:
        bm = {"blockmax": True, "valid_len": len(codes)}
        res.update(int32_bm_ms=ms(False, bm), int32_quirk_bm_ms=ms(True, bm),
                   i16_bm_ms=ms(False, dict(bm, max_sub=2)))
    if "gate" in inspect.signature(cuda_sw.forward_shared).parameters:
        # the bounded-radius gate: the card's tiers for K = 4, and every
        # column forced to depth 0 (thresholds above any column max: the
        # most the gate can save; the outputs are then not exact)
        from ssw_tpu_torch.ops import gate
        for label, thr in (("gate", gate.card_thresholds(4, 128, 3, 1, 2)),
                           ("depth0", (1 << 27,) * gate.DEPTHS)):
            res[f"int32_bm_{label}_ms"] = ms(False, dict(bm, gate=thr))
            res[f"i16_bm_{label}_ms"] = ms(False, dict(bm, max_sub=2,
                                                        gate=thr))
            res[f"int32_quirk_{label}_ms"] = ms(True, {"gate": thr})
    scan = "scan_body" in inspect.signature(cuda_sw.forward_shared).parameters
    wave32 = "sw_wave_i32" in _kernels.KERNELS
    if scan:
        for label, kw in (("i16", {"max_sub": 2}),
                          ("i16_bm", dict(bm, max_sub=2))):
            res[f"{label}_scan_body_ms"] = ms(False, dict(kw,
                                                          scan_body=True))
    if wave32:
        for label, quirk, kw in (("int32", False, {}),
                                 ("int32_quirk", True, {}),
                                 ("int32_bm", False, bm),
                                 ("int32_quirk_bm", True, bm)):
            res[f"{label}_scan_body_ms"] = ms(quirk,
                                              dict(kw, scan_body=True))
        res.update(_ion_x20_leaf(torch, common, cuda_sw, codes, ref))
    if hasattr(cuda_sw, "forward_shared_packed"):
        res.update(_packed_leaves(torch, common, cuda_sw, codes, ref, reads,
                                  mat, scan))
    if hasattr(cuda_sw, "forward_shared_gated"):
        halo = 320
        idx = torch.arange(len(ref), dtype=torch.int32, device="cuda") - halo
        own = idx >= 0

        def owned(quirk, kw):
            cuda_sw.forward_shared_gated(args[0], args[1], idx, own,
                                         *args[2:], quirk, **kw)
        for label, kw in (("int32", {}), ("i16", {"max_sub": 2})):
            res[f"{label}_base_ms"] = ms(False, kw)
            res[f"{label}_owned_ms"] = ms(False, kw, fn=owned)
            res[f"{label}_base2_ms"] = ms(False, kw)
        if scan:
            res["i16_owned_scan_body_ms"] = ms(
                False, {"max_sub": 2, "scan_body": True}, fn=owned)
        if wave32:
            res["int32_owned_scan_body_ms"] = ms(
                False, {"scan_body": True}, fn=owned)
    return res


def _ion_x20_leaf(torch, common, cuda_sw, codes, ref):
    """An int32 leaf like the Ion Torrent x20 one: 117 reads of 273-304
    bp (seed 3, 1 % substitutions) in L = 320, the default DNA penalties
    scaled by 20 (outside the int16 tier), dual (word rows a prefix of the
    byte rows) and blockmax over the 2^20 columns, the wavefront and the
    column-scan body."""
    rng = np.random.default_rng(3)
    reads = []
    for ln, s in zip(rng.integers(273, 305, 117),
                     rng.integers(20000, len(codes) - 600, 117)):
        r = codes[s:s + ln].copy()
        m = rng.random(ln) < 0.01
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    rl = np.array([len(r) for r in reads], np.int32)
    mat = np.full((5, 5), -40, np.int8)
    np.fill_diagonal(mat, 40)
    mat[4, :] = mat[:, 4] = 0
    L = 320
    prof = common.build_profile(common.pad_reads(reads, L, 4), rl,
                                common.extend_matrix(mat))
    byte = common.batch_geometry(rl, L, word=False)
    word = common.batch_geometry(rl, L, word=True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).cuda()
    args = (t(prof), t(ref), t(rl), t(byte.col_mask), t(byte.seg_id),
            t(byte.seg_start), 60, 20, False)
    out = {}
    for label, kw in (("bm", {}), ("dual", {"wmask": t(word.col_mask)})):
        kw = dict(kw, blockmax=True, valid_len=len(codes))
        for body in (False, True):
            out[f"ion_x20_int32_{label}" + ("_scan_body" if body else "")
                + "_ms"] = _event_ms(torch, lambda: cuda_sw.forward_shared(
                    *args, **kw, scan_body=body), reps=1)
    return out


def _event_ms(torch, run, reps=3):
    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _packed_leaves(torch, common, cuda_sw, codes, ref, reads, mat, scan):
    """The packed kernel: the config-4 reads at 1024 lanes (blockmax), and
    an Ion-like L = 192 leaf in dual mode."""
    rng = np.random.default_rng(2)
    ion = []
    for ln, s in zip(rng.integers(120, 177, 1024),
                     rng.integers(20000, len(codes) - 200, 1024)):
        r = codes[s:s + ln].copy()
        m = rng.random(ln) < 0.01
        r[m] = rng.integers(0, 4, int(m.sum()))
        ion.append(r)
    out = {}
    for label, rs, L, dual in (("packed", reads, 128, False),
                               ("packed_dual_ion", ion, 192, True)):
        rl = np.array([len(r) for r in rs], np.int32)
        plan = common.pack_plan((rl + 15) // 16 * 16, 1024)
        so, sl, rl_s = common.pack_tables(plan, rl)
        prof = common.build_profile(
            common.pack_codes(plan, common.pad_reads(rs, L, 4), 4), None,
            common.extend_matrix(mat))
        fi = (plan.row * plan.S + plan.slot).astype(np.int32)
        args = tuple(torch.as_tensor(np.ascontiguousarray(a)).cuda()
                     for a in (prof, ref, so, sl, rl_s, fi)) + (3, 1)
        kw = dict(max_sub=2, valid_len=len(codes), dual=dual)
        out[f"{label}_ms"] = _event_ms(
            torch, lambda: cuda_sw.forward_shared_packed(*args, **kw))
        if scan:
            out[f"{label}_scan_body_ms"] = _event_ms(
                torch, lambda: cuda_sw.forward_shared_packed(
                    *args, scan_body=True, **kw))
    return out


ION_GENOME = 4_938_920
PEAK_OPS = 1.673e13  # INT32 op/s of one H100 (PERF.md's kernel table)


def ion_leaves(device):
    """The Ion Torrent headline's leaves as pipeline.align_batch_launch
    plans them (reads drawn as tools/make_data.py draws them, seed
    4,938,920): [(leaf state, forward_shared_packed's positional
    arguments, its keywords)] with the inputs on `device`."""
    import torch
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.core.encoding import dna_matrix
    from ssw_tpu_torch.ops import common

    rng = np.random.default_rng(ION_GENOME)
    bases = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.int8)
    code[bases] = np.arange(4)
    genome = rng.choice(bases, ION_GENOME).astype(np.uint8)
    reads = []
    for _ in range(1000):
        ln = int(np.clip(rng.normal(200, 80), 25, 540))
        pos = int(rng.integers(0, len(genome) - ln))
        rd = genome[pos:pos + ln].copy()
        m = rng.random(ln) < 0.01
        if m.any():
            rd[m] = rng.choice(bases, int(m.sum()))
        reads.append(code[rd])
    req = pipeline.BatchRequest(reads=reads, ref=code[genome],
                                mat=dna_matrix(2, 2), gapO=3, gapE=1)
    dev = torch.device(device)
    out = []
    for _, leaf_req, streaming in pipeline._plan_leaves(req):
        st = pipeline._leaf_prepare(leaf_req, dev, streaming)
        rp = common.pad_reads(leaf_req.reads, st.L, st.n)
        mat_ext = pipeline._to(dev, common.extend_matrix(st.req.mat),
                               torch.int8)
        pprof, tables = pipeline._packed_inputs(
            st.plan, rp[st.keep], st.read_len[st.keep], st.B, st.n, mat_ext)
        kw = dict(max_sub=st.max_sub, valid_len=st.ref_len, quirk=st.quirk,
                  word=bool(st.word_tier), dual=st.dual,
                  slot_max=int(st.plan.slot_len.max()))
        out.append((st, (pprof, st.ref_codes, *tables, 3, 1), kw))
    return out


@contextlib.contextmanager
def pinned_stretches(P):
    """The packed wavefront's launches split into P stretches per read
    (pack.stretch_rule answers P; cuda_sw.packed_launch still lowers it so
    that no stretch is empty); P None: the rule's."""
    from ssw_tpu_torch.ops import pack

    rule = pack.stretch_rule
    if P is not None:
        pack.stretch_rule = lambda *a: P
    try:
        yield
    finally:
        pack.stretch_rule = rule


def ion_sweep(Ps, reps: int = 2) -> list:
    """ms of each Ion leaf's packed forward at each P of Ps and at the
    rule's P (ion_leaves on the card)."""
    import torch
    from ssw_tpu_torch.ops import _kernels, cuda_sw, pack

    _kernels.build()
    rows = []
    for i, (st, args, kw) in enumerate(ion_leaves("cuda")):
        B = st.B
        slot = st.plan.slot_len[:B]
        rule = cuda_sw.packed_launch(
            B, kw["slot_max"], int(args[0].shape[1]), st.ref_len,
            st.max_sub, 3, 1, st.quirk, st.dual, st.dev)[0]
        lanes = pack.packed_lanes(kw["slot_max"])
        wpb, resident = cuda_sw.packed_shape(lanes, int(args[0].shape[1]),
                                             st.quirk, st.dual, st.dev)
        row = {"leaf": i, "reads": B, "lanes": lanes, "K": lanes // 32,
               "rule_P": rule, "warps_per_block": wpb,
               "resident_warps_per_sm": resident,
               "bound_ms": cuda_sw.packed_ops(
                   slot, st.read_len, st.ref_len, st.quirk, st.dual)
               / PEAK_OPS * 1e3,
               "card": torch.cuda.get_device_name(0)}
        for P in list(Ps) + [None]:
            with pinned_stretches(P):
                row[f"P{P or 'rule'}_ms"] = _event_ms(
                    torch, lambda: cuda_sw.forward_shared_packed(*args, **kw),
                    reps=reps)
        rows.append(row)
    return rows


def main(argv: list[str]) -> int:
    if argv[:1] == ["--ion"]:
        for row in ion_sweep([int(p) for p in argv[1:]]
                             or [1, 2, 4, 8, 16, 32]):
            print(json.dumps(row), flush=True)
        return 0
    if argv[:1] == ["--one"]:
        print(json.dumps(_time_tree(argv[1])), flush=True)
        return 0
    # each tree in a fresh process whose import path starts at that tree
    # (run with -c: a script's own directory would lead the path)
    code = f"exec(open({os.path.abspath(__file__)!r}).read())"
    for tree in argv or ["."]:
        r = subprocess.run([sys.executable, "-c", code, "--one", tree])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
