"""Each driver at a tiny size on the CPU: a whole run (the harness's look
for a card skipped), its result line, and its check failing under each
fault the cell can have.  The weights are drawn in float32 here: the port
then computes what the float32 reference does, to rounding, so that the
check's agreement is exact in kind; at these widths a bf16 subject's noise
moves top-k boundaries far more than at the cell's."""

import io
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers.cache_common import CONTROLS
from benchmark.tests.tiny import IMAGE, TEXT, tiny_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True)
def fp32_weights(monkeypatch):
    from benchmark import weights

    draw = weights.draw_group

    def float32(spec, seed, name, device, dtype):
        return draw(spec, seed, name, device, torch.float32 if dtype == torch.bfloat16 else dtype)

    monkeypatch.setattr(weights, "draw_group", float32)


def run(name, faults=(), trace=False, seconds=1.0, seed=2**31 + 11):
    return harness.run_cell(name, seed, seconds, trace, device="cpu", cell=tiny_cell(name), faults=faults,
                            t_start=time.perf_counter())


@pytest.mark.parametrize("name", [TEXT, IMAGE])
def test_result_line(name):
    r = run(name)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(r, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in harness.load_cell(name).end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", [TEXT, IMAGE])
def test_traced_line(name):
    r = run(name, trace=True)
    assert set(r) == KEYS and set(r["device"]) >= {"busy_s", "window_s"}
    assert any(m.startswith("mfu.") for m in r["metrics"]) and r["correct"] is True
    assert set(r["metrics"]) <= {m["name"] for m in harness.load_cell(name).per_layer}


@pytest.mark.parametrize("fault", ["stale", "half_batch", "alter"])
@pytest.mark.parametrize("name", [TEXT, IMAGE])
def test_faults_fail_the_check(name, fault):
    assert run(name, faults=(fault,))["correct"] is False


@pytest.mark.parametrize("name", [TEXT, IMAGE])
def test_each_control_in_the_programs_place_is_not_correct(name):
    """Each control (the reference one precision step lower: fp8 products
    with a TF32 encoder, and the TF32 encoder alone), put in the program's
    place, is judged by the harness as the program is and comes out not
    correct, reading many times what the port reads."""
    r = run(name, faults=tuple(CONTROLS))
    assert r["correct"] is True and set(r["controls"]) == set(CONTROLS)
    prog = {k: c["value"] for k, c in r["checks"].items()}
    assert max(prog["act_err"], prog["sel_gap"], prog["enc_err"], prog["enc_sel"]) < 1e-4, prog
    for side, c in r["controls"].items():
        assert c["correct"] is False, (side, c)
    ctrl = {side: {k: v["value"] for k, v in c["checks"].items()} for side, c in r["controls"].items()}
    for number in ("act_err", "sel_gap"):
        assert ctrl["control.fp8"][number] > 3 * prog[number], (number, prog, ctrl)
    assert ctrl["control.tf32"]["enc_err"] > 3 * prog["enc_err"], (prog, ctrl)
    assert ctrl["control.tf32"]["enc_err"] > r["checks"]["enc_err"]["limit"], ctrl


@pytest.mark.parametrize("name", [TEXT, IMAGE])
def test_keeper_samples_the_window(name):
    """The encoder's check reads hiddens kept across the whole window: as
    many rows as asked for, each of a batch the window ran."""
    cell = tiny_cell(name)
    r = harness.run_cell(name, 2**31 + 5, 1.0, False, device="cpu", cell=cell, t_start=time.perf_counter())
    assert r["correct"] is True and r["attempted"] > cell.workload["traffic"]["encoder_rows"]
