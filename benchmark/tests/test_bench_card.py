"""On the card, at each cell's own size: a short run whose check also puts
each control (the reference one precision step lower: fp8 products with a
TF32 encoder, and the TF32 encoder alone) in the program's place.  The
program comes out correct and each control, judged by the harness as the
program is, not correct.  Run on the card with
`python -m pytest benchmark/tests/test_bench_card.py`; elsewhere they skip."""

import time

import pytest

from benchmark import harness
from benchmark.drivers.cache_common import CONTROLS

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_limits(card, name):
    harness.fixed_environment()
    r = harness.run_cell(name, 2**31 + 101, 4.0, False, device=card, faults=tuple(CONTROLS),
                         t_start=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert set(r["controls"]) == set(CONTROLS)
    for side, c in r["controls"].items():
        assert c["correct"] is False, (side, c["checks"])
