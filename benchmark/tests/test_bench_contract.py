"""BENCHMARK.json against the contract's shapes, and its files present."""

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        f = harness.load_json(harness.BENCH_DIR / "workloads" / f"{w['name']}.json")
        assert f["config"] == w["config"] and f["mix"] == w["traffic"] and f["chips"] == w["chips"]
        assert (harness.BENCH_DIR / "drivers" / f"{f['entry']}.py").exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (harness.BENCH_DIR / "layer_metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    c = harness.load_cell(cell, BENCH)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert set(c.workload["rates"]) == e2e - {"setup_s"}


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
