"""The bounded-radius gate of the forward kernels: when no lazy-F carry can
travel further than a radius, the prefix-max scan of a column may stop
short of the whole row.  The gate changes no output.

The JAX package's TPU kernel truncates its lane prefix max to GATE_RADIUS
for a 16-column group whose sampled max H (over a 32k-lane chunk) is below
a threshold (ssw_tpu/ops/pallas_sw.py: tiers :334-353, gate_plan :645).  On
the card a warp holds one read (two for the int16 tier, one slot when
packed) and already reduces its masked column max every column, so the gate
is per read and per column: a column takes scan depth m (m of the warp
scan's 5 shuffle steps, covering 2^m threads of K lanes each), the least m
whose threshold admits the previous column's max, else the full scan.

Thresholds per launch come as thr[0..4] (int, non-decreasing, NEG =
depth disabled): depth = #{m : hm > thr[m]}.  Two sources:
  * plan_thresholds: the JAX plan (gate_plan), each radius r mapped to the
    least depth that covers r - 1 lanes, with the JAX threshold
    gapO + (r-1)*gapE - UNROLL*max_sub (checked every column, so stricter
    than the TPU's once per group);
  * card_thresholds: every depth, thr[m] = gapO + 2^m*K*gapE - lag*max_sub.

Exactness (copied into csrc/sw_dp.cuh): a depth-m scan plus the in-thread
sweeps covers every source p' with p - p' <= 2^m*K; a dropped source gives
lane p at most max h~ - gapO - 2^m*K*gapE, inert (<= 0, and H = max(h~, F,
0)) whenever max h~ <= gapO + 2^m*K*gapE.  Over the col_mask lanes (a
prefix of the row, so of every valid lane's sources) max h~(j) <= colmax(j
- lag) + lag*max_sub, since h~(j, p) <= max(H(j-1, p-1) + max_sub,
H(j-1, p)) lane by lane.
"""

from __future__ import annotations

NEG = -(2 ** 28)  # a disabled depth (scan_sw.NEG): no colmax is below it
DEPTHS = 5        # shuffle steps of the full warp scan (2^5 = 32 threads)

# The JAX package's constants (ssw_tpu/ops/pallas_sw.py:64-80)
UNROLL = 16              # columns per gate sample on the TPU (its slack)
GATE_RADIUS = 64         # truncated prefix-max radius of the tight tier
GATE_RADIUS2 = 128       # the wide tier (GATE2)
NOISE_CEIL_PER_SUB = 21  # a tier whose threshold is under 21 * max_sub
                         # never opens on a 32k-lane chunk (TPU heuristic)

# Module switches, the counterparts of the JAX package's environment
# variables SSW_TPU_GATESCAN ("1" on, "0" off, "force": ignore the noise
# ceiling) and SSW_TPU_GATE2 (add the radius-128 tier).
GATESCAN = "1"
GATE2 = False

LAG = 1  # columns between the gate's sample and the column it gates (the
         # kernels sample the previous column's masked max)


def gate_plan(L: int, gapO: int, gapE: int, max_sub: int | None,
              pack_bound: int | None = None
              ) -> tuple[int | None, tuple[int, ...]]:
    """(gate_sub, radii): the JAX package's bounded-radius tiers that are
    provable and profitable, tightest first; (None, ()) disables the gate.
    A tier needs max|mat|, a scan longer than its radius (packed: the slot
    bound), a positive threshold and, unless GATESCAN == "force", a
    threshold above the noise ceiling NOISE_CEIL_PER_SUB * max_sub."""
    if max_sub is None or GATESCAN == "0":
        return None, ()
    eff = L if pack_bound is None else min(L, pack_bound)
    allowed = (GATE_RADIUS, GATE_RADIUS2) if GATE2 else (GATE_RADIUS,)
    floor = 0 if GATESCAN == "force" else NOISE_CEIL_PER_SUB * max_sub
    radii = tuple(
        r for r in allowed
        if r < eff and gapO + (r - 1) * gapE - UNROLL * max_sub > floor)
    if not radii:
        return None, ()
    return int(max_sub), radii


def gate_sub_for(L: int, gapO: int, gapE: int,
                 max_sub: int | None) -> int | None:
    """max_sub when gate_plan returns a tier, else None."""
    return gate_plan(L, gapO, gapE, max_sub)[0]


def _finish(thr):
    """Non-decreasing thresholds (a column that clears depth m's also takes
    no deeper one), or None when no depth is enabled."""
    out, run = [], NEG
    for t in thr:
        run = max(run, t)
        out.append(run)
    return tuple(out) if run > NEG else None


def plan_thresholds(K: int, L: int, gapO: int, gapE: int,
                    max_sub: int | None,
                    pack_bound: int | None = None) -> tuple | None:
    """Per-depth thresholds of the JAX plan gate_plan(L, ..., pack_bound)
    for a warp of K lanes per thread; None when the plan has no tier that a
    depth below 5 covers."""
    gate_sub, radii = gate_plan(L, gapO, gapE, max_sub, pack_bound)
    if gate_sub is None:
        return None
    thr = [NEG] * DEPTHS
    for r in radii:
        m = next((m for m in range(DEPTHS) if (K << m) >= r - 1), None)
        if m is not None:
            thr[m] = max(thr[m], gapO + (r - 1) * gapE - UNROLL * gate_sub)
    return _finish(thr)


def card_thresholds(K: int, span: int, gapO: int, gapE: int,
                    max_sub: int | None) -> tuple | None:
    """Per-depth thresholds of the card's own tiers for a warp of K lanes
    per thread whose rows hold `span` lanes that matter (L, or the longest
    slot when packed): thr[m] = gapO + 2^m*K*gapE - LAG*max_sub, disabled
    where 2^m*K >= span or thr <= 0; None without max_sub."""
    if max_sub is None:
        return None
    thr = []
    for m in range(DEPTHS):
        t = gapO + (K << m) * gapE - LAG * max_sub
        thr.append(t if (K << m) < span and t > 0 else NEG)
    return _finish(thr)

