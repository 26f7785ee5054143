"""The check's control comes out not correct: the step below each
configuration's precision fails one of its cell's numbers.

* On the card, at each cell's own size: the float32 task's control is the
  program itself with TF32 products; the bfloat16 LM's is the reference
  computed in float8 (e4m3, one power-of-two scale a tensor).  One seed a
  cell (the limits were set from three or more; PERF.md).
* On the CPU, at a tiny size: the LM's float8 control against the tiny
  limits of `test_perfbench_faults` (the CPU has no TF32, so the float32
  control needs the card)."""

import pytest
import torch

from perfbench import calibrate, harness, spec
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_faults import TINY_LM_LIMITS

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _fails(gaps: dict, limits: dict) -> list:
    return [k for k, v in gaps.items() if k in limits and not v <= limits[k]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    _, config, workload = spec.load_cell(cell)
    r = calibrate.readings(config, workload, 2**31 + 911, card, control=True, plant=[])
    assert not _fails(r["sound"], workload["limits"]), r["sound"]
    assert _fails(r["control"], workload["limits"]), r["control"]


def test_lm_control_fails_at_a_tiny_size():
    cpu = torch.device("cpu")
    ref = harness.reference_rounds(tiny.LM, tiny.lm_workload(), 2**31 + 9, cpu, harness.precision_of(tiny.LM))
    ctl = harness.reference_rounds(tiny.LM, tiny.lm_workload(), 2**31 + 9, cpu, harness.family(tiny.LM).CONTROL)
    gaps = harness.compare(ctl, ref)
    gaps.pop("_at")
    assert _fails(gaps, TINY_LM_LIMITS), gaps
