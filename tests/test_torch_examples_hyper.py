"""The hyper-representation twin (``examples/hyper_representation_torch.py``)
against the reference's own script on the CPU, by the rules and helpers of
``test_torch_examples.py``: the task at n = 400, side = 6 (m, c, h, hidden
and the seed the script's), the reference's backbone and head, each run's
rounds capped at 5.

About 22 s on one worker (the reference's four jitted round bodies)."""

import builtins
import sys

import jax

from test_torch_examples import assert_same_printed, load, printed, record_reference_selections, task_factories


def test_hyper_representation(monkeypatch):
    """--fast: ring and two-hop, C2DFB and the naive-compression ablation on
    the reference's backbone and head.  T is hard-coded in the script's
    loops (15), so ``range`` is the global that caps it, at 5 rounds: the
    ablation is unstable (its hypergradient grows from 0.55 to 3.8 over the
    15 rounds), so the two packages' last-bit differences grow with it, 1.7e-5
    of the hypergradient by round 6 and past the golden tolerance by round 15
    even on the same selections.  The twin keeps the coordinates the
    reference kept in every compression (`selection.imposed`), each row whose
    own choice differs checked to be a near-tie the packages' rounding
    decides, as tests/test_torch_async.py's gate rows do (the free ablation
    parts at one in round 8 on the ring)."""
    from repro_torch.core import selection

    rounds = 5
    ref, twin = load("hyper_representation"), load("hyper_representation_torch")
    ref.hyper_representation_task, twin.hyper_representation_task = task_factories(
        "hyper_representation_task", dict(n=400, side=6))
    for mod in (ref, twin):
        mod.range = lambda n: builtins.range(min(n, rounds))
    log = record_reference_selections(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["hyper_representation", "--fast"])
    want = printed(ref.main)
    jax.effects_barrier()
    # topologies x methods x rounds x K x loops x (d, s) x the head's w, b
    assert len(log) == 2 * 2 * rounds * 8 * 2 * 2 * 2
    seen = selection.Partings()
    with selection.imposed(log, seen):
        got = printed(twin.main, ["--fast", "--device", "cpu"])
    assert seen.compressions == len(log)
    assert_same_printed(want, got, exact=[r"\([\d.]+ MB\)"])
