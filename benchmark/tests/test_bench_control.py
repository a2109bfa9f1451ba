"""The control (the reference in a saturating signed byte in the
program's place) comes out not correct on every cell, at a size a CPU run
holds; the same comparison with the reference in full precision in the
program's place comes out correct.  On the card at each cell's own size:
`python3 benchmark/control.py --workload <cell> --seeds 11 12 13`."""

import pytest

from conftest import small

from benchmark import check, control, harness


@pytest.mark.parametrize("workload", ["illumina_1M.batch",
                                      "iontorrent_5M.batch",
                                      "illumina_1M.local"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(workload, seed):
    cfg, traffic = small(workload)
    res = control.control_run(workload, seed, 3, "cpu", harness.manifest(),
                              cfg, traffic)
    assert not res["correct"]
    differ = [c for k, c in res["checks"].items() if k.endswith("differing")]
    assert differ[0]["value"] > 0


def test_full_precision_in_the_programs_place_is_correct(monkeypatch):
    monkeypatch.setattr(check, "SAT_CONTROL", None)
    cfg, traffic = small("illumina_1M.batch")
    res = control.control_run("illumina_1M.batch", 11, 3, "cpu",
                              harness.manifest(), cfg, traffic)
    assert res["correct"]
