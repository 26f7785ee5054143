"""The plain reference against the program's own rounds on the CPU at tiny
sizes: the numbers the check compares.

On the CPU the float32 task runs the same operators on both sides, but
for the logits' sum over the features, which the reference takes in
chunks: its first gradients part by a few float32 roundings, and its
later numbers where a sum is taken in another order.  The bfloat16 LM stores every state leaf
and gradient in bfloat16 on both sides, but the reference computes each
update in float32 before it rounds, where the program rounds each
operator: leaves part by about one bfloat16 step (2^-8) in places, and a
top-k selection parts at a tie.  The bounds below are a few such steps;
the change is held to 16 of them, since at this width the head moves by
a few bfloat16 steps a round (six seeds read 0.013 to 0.047)."""

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CPU = torch.device("cpu")
BF16_STEP = 2.0 ** -8


def _gaps(config, workload, seed):
    prog = harness.build_program(config, workload, seed, CPU)
    _, rec = harness.check_rounds(prog)
    ref = harness.reference_rounds(config, workload, seed, CPU, harness.precision_of(config))
    gaps = harness.compare(rec, ref)
    gaps.pop("_at")
    return gaps


@pytest.mark.parametrize("compressor", ["kernel_topk", "kernel_quant"])
def test_coef_reference_follows_the_program(compressor):
    gaps = _gaps(tiny.COEF, tiny.coef_workload(compressor), 2**31 + 77)
    assert gaps["grad_gap"] < 1e-6, gaps
    assert gaps["bytes_gap"] == 0.0
    assert gaps["step_dir_gap"] < 1e-3, gaps
    assert gaps["loss_gap"] < 1e-5 and gaps["change_gap"] < 1e-5, gaps


def test_lm_reference_follows_the_program():
    gaps = _gaps(tiny.LM, tiny.lm_workload(), 2**31 + 78)
    assert gaps["grad_gap"] < BF16_STEP, gaps
    assert gaps["loss_gap"] < 2 * BF16_STEP, gaps
    assert gaps["change_gap"] < 16 * BF16_STEP, gaps
    assert gaps["bytes_gap"] < BF16_STEP, gaps


def test_reference_imports_nothing_of_the_program():
    import ast

    from perfbench import spec

    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax"), (path.name, name)
