"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (`perfbench.faults`): a round that returns its
state unchanged, half of each node's rows left out, the exchange between
nodes left out, an answer (a compressed message) altered where it is
made.  The run is driven past the look for a card, on the CPU at a tiny
size.

At this tiny width the faults move the numbers by other amounts than at
the cells' own size (there, PERF.md), so each case is held to limits set
from tiny readings: the float32 task to its cells' limits but a change
limit of 0.1 (sound runs read under 1e-6, a missing exchange 0.30 to
0.37); the bfloat16 LM, which rounds by a larger share of each leaf here
(six sound seeds read up to 0.0052, 0.0017, 0.047 and 0.0012), to 0.02,
0.005, 0.15 and 0.01."""

import time

import pytest
import torch

from perfbench import faults, harness, spec
from perfbench.tests import tiny

TINY_LM_LIMITS = {"loss_gap": 0.02, "grad_gap": 0.005, "change_gap": 0.15, "bytes_gap": 0.01}
CASES = [("coef-20ng.topk-k10", tiny.COEF, tiny.coef_workload("kernel_topk")),
         ("coef-20ng.quant-b4", tiny.COEF, tiny.coef_workload("kernel_quant")),
         ("lm", tiny.LM, tiny.lm_workload())]


def _limits(cell: str) -> dict:
    if cell == "lm":
        return TINY_LM_LIMITS
    return {**spec.load_cell(cell)[2]["limits"], "change_gap": 0.1}


def _run(monkeypatch, cell, config, workload, plant):
    limits = _limits(cell)
    build = harness.build_program
    monkeypatch.setattr(harness, "build_program", lambda *a, **k: build(*a, **k, plant=plant))
    return harness.run_cell(config, workload, 2**31 + 5, 0.2, False, torch.device("cpu"), [], time.perf_counter(),
                            limits=limits)


@pytest.mark.parametrize("cell,config,workload", CASES, ids=[c[0] for c in CASES])
def test_sound_run_is_correct(monkeypatch, cell, config, workload):
    out = _run(monkeypatch, cell, config, workload, [])
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell,config,workload", CASES, ids=[c[0] for c in CASES])
def test_fault_is_caught(monkeypatch, cell, config, workload, fault):
    out = _run(monkeypatch, cell, config, workload, [fault])
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", faults.STEP_FAULTS)
@pytest.mark.parametrize("cell,config,workload", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_wrong_step_rule_is_caught(monkeypatch, cell, config, workload, fault):
    """The float32 task's x and y move, so a step of the right size the
    wrong way fails: the outer one by the direction of x's change alone
    (its norm reads as sound's), the inner one by the change's norms.  (The
    bfloat16 LM's steps round away; PERF.md.)"""
    out = _run(monkeypatch, cell, config, workload, [fault])
    assert not out["correct"], (fault, out["checks"])
    if fault == "outer_step_flipped":
        assert out["checks"]["step_dir_gap"]["value"] > 1.9, out["checks"]
