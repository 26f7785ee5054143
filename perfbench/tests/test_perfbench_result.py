"""The result line of a run: its keys in order, the metrics of the cell by
name and unit, and the checks last; with and without the trace (on the CPU
at a tiny size: the device's numbers are then absent, not zero)."""

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests import tiny

LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3, "bytes_gap": 1e-3}


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    bench = spec.load_benchmark()
    metrics = spec.cell_metrics(bench, "coef-20ng.topk-k10", trace)
    out = harness.run_cell(tiny.COEF, tiny.coef_workload(), 11, 0.3, trace, torch.device("cpu"), metrics,
                           time.perf_counter(), limits=LIMITS)
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    units = {m["name"]: m["unit"] for m in metrics}
    for name, v in out["metrics"].items():
        assert v["unit"] == units[name] and v["value"] is not None
    if not trace:
        assert {"round_ms", "peak_gb", "setup_s"} <= set(out["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(LIMITS) | {"flags_changed"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out)


def test_precision_settings_changed_in_the_window_are_not_correct(monkeypatch):
    """A program that turns TF32 on once the checked rounds are behind it
    (here: from its fourth round on, the window's first) has its window
    computed otherwise than the rounds the check held: not correct."""
    build = harness.build_program
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_tf32", matmul.allow_tf32)  # restored after the test

    def build_late_tf32(*a, **k):
        prog = build(*a, **k)
        inner, calls = prog["round"], []

        def late(*args, **kwargs):
            calls.append(1)
            if len(calls) > harness.CHECK_ROUNDS:
                matmul.allow_tf32 = True
            return inner(*args, **kwargs)

        return {**prog, "round": late}

    monkeypatch.setattr(harness, "build_program", build_late_tf32)
    out = harness.run_cell(tiny.COEF, tiny.coef_workload(), 12, 0.2, False, torch.device("cpu"), [],
                           time.perf_counter(), limits=LIMITS)
    assert out["checks"]["flags_changed"]["value"] >= 1
    assert out["correct"] is False


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    run = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", "coef-20ng.topk-k10",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    assert run.returncode != 0
    assert run.stdout.strip() == ""


def test_p90_needs_ten_rounds_beyond():
    assert harness._p90(list(range(99))) is None
    assert harness._p90([1.0] * 100) == 1.0
