"""What every comparison shares.  An entry's own comparison is
compare/<entry>.py (found by the traffic mix's `entry`): a
`compare(driver, device, sat, timings)` that returns its numbers, each
{"value", "limit"} (and "of": how many were compared), and a
`plant_control(driver, calls, device, sat)` that puts the control's
answers in the program's place."""

from __future__ import annotations

SAT_CONTROL = 127  # the control: every score held in a saturating int8


def count(value: int, of: int | None = None) -> dict:
    """An exact comparison: `value` wrong answers, limit 0."""
    d = {"value": int(value), "limit": 0}
    if of is not None:
        d["of"] = int(of)
    return d


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
