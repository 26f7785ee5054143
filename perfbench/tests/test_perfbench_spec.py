"""BENCHMARK.json and the files it names: every cell, configuration and
metric file loads, its names and units keep to the allowed characters,
and every metric's ``moves`` and cell list agree with the cells that
report it."""

import importlib
import json

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), [n for n in names if not spec.NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("perfbench/")
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    importlib.import_module(f"perfbench.families.{cfg['family']}")
    assert sum(1 for c in BENCH["workloads"] if c["config"] == entry["name"]) >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file(cell):
    entry = spec.workload_entry(BENCH, cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    _, config, workload = spec.load_cell(cell)
    assert workload["name"] == cell
    assert {"grad_gap", "change_gap"} <= set(workload["limits"]) <= {"loss_gap", "grad_gap", "change_gap", "bytes_gap",
                                                            "step_dir_gap"}
    assert all(v > 0 for v in workload["limits"].values())
    assert workload["trace_rounds"] >= 1


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS), (metric["name"], cell)
    reader = importlib.import_module(f"perfbench.metrics.{metric['name']}")
    assert callable(reader.read)


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        e2e = {m["name"] for m in spec.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(BENCH, cell, True), cell


def test_layers_name_one_layer_each():
    by_layer = {}
    for m in BENCH["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert len(by_layer) >= 4


def test_check_budget_fits():
    """A full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60,
    each cell 180 s of compiles, 1,200 s spare, within 43,200 s."""
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
