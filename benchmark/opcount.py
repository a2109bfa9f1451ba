"""The forward pass's work and the card's peak for it, counted from the
inputs and never from the program's plans, so that the count reads the
same whatever implements the pass.

  * Cells: one full read x target matrix per read and strand that the
    flags ask for (read_len x target_len, both strands under -r).  Tier
    re-runs, padding lanes and packing slots are not work.
  * Operations: 7 integer operations per cell, the recurrence as
    ssw_tpu_torch/ops/cuda_sw.py OPS_PER_CELL documents it (copied here).
  * Peak: the card's fastest native form, 16-bit pairs (two operations
    an instruction: 3.5 instructions a cell) at `int32_lanes_per_sm` x
    `sms` x `clock_mhz` instructions a second (peaks.json).

A kernel that prunes cells (the bounded-radius gate) would need this
count revisited: it would do less than the full matrix.
"""

from __future__ import annotations

import json
import os

OPS_PER_CELL = 7
PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def forward_cells(read_lens, target_len: int, strands: int) -> int:
    return int(sum(int(n) for n in read_lens)) * int(target_len) * strands


def peak_cells_per_s(device_name: str) -> float | None:
    """Cells per second at the card's peak, None for a card not in the
    table."""
    with open(PEAKS) as f:
        p = json.load(f).get(device_name)
    if p is None:
        return None
    instr_per_s = p["int32_lanes_per_sm"] * p["sms"] * p["clock_mhz"] * 1e6
    return instr_per_s * p["ops_per_instruction"] / OPS_PER_CELL
