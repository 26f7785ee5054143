"""The benchmark's declaration: ``BENCHMARK.json`` at the root of the
checkout, and the files it names.

A cell (an entry of ``workloads``) is found by its name:
``perfbench/workloads/<cell>.json`` holds its traffic and its limits, and
names its configuration, whose file ``BENCHMARK.json`` gives.  A per-layer
metric is found by its name too: ``perfbench/metrics/<metric>.py``.  So a
new cell, configuration or metric is a new file and a new entry, and no
file here changes.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    tracing off, its per-layer metrics with tracing on.  A metric without a
    ``workloads`` key belongs to every cell (a per-layer one: every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's configuration file, its workload file)."""
    bench = load_benchmark(root)
    entry = workload_entry(bench, name)
    config = read_json(root / config_entry(bench, entry["config"])["file"])
    workload = read_json(root / "perfbench" / "workloads" / f"{name}.json")
    if workload.get("config") != entry["config"] or workload.get("traffic") != entry["traffic"]:
        raise ValueError(f"perfbench/workloads/{name}.json names {workload.get('config')}/{workload.get('traffic')}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    return bench, config, workload


def c2dfb_settings(config: dict, workload: dict) -> dict:
    """The cell's C2DFBConfig arguments: the configuration's step sizes and
    the workload's compressor and K."""
    return {**config["c2dfb"], **workload["c2dfb"]}
