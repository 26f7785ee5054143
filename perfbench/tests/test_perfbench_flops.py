"""The families' closed-form model FLOPs against the program's own count of
a round (``repro_torch.obs.compute.round_cost``: FlopCounterMode over every
product the round runs) at small shapes.

The coefficient-tuning round runs exactly the model's products and the
mixing.  The LM round runs them, the mixing, and what the program
recomputes: each repeat's forward once per shard in the x-partials'
backward, and the chunked cross-entropy's logits in the backward passes
(K + 3 to K + 5 head products, by what the round finds in its memo of
x's values)."""

import pytest
import torch

from perfbench import harness
from perfbench.families import lm_bilevel
from perfbench.tests import tiny


def _round_cost(config, workload, warm: bool):
    from repro_torch.core.c2dfb import c2dfb_round, init_state
    from repro_torch.obs.compute import round_cost

    prog = harness.build_program(config, workload, 3, torch.device("cpu"))
    state = init_state(prog["problem"], prog["cfg"], prog["x0"], prog["y0"])
    if warm:
        state, _ = c2dfb_round(state, prog["generator"], prog["problem"], prog["topo"], prog["cfg"], W=prog["W"])
    _, cost = round_cost(c2dfb_round, state, prog["generator"], prog["problem"], prog["topo"], prog["cfg"],
                         prog["W"])
    return prog, cost.flops


@pytest.mark.parametrize("K", [1, 3])
def test_coef_closed_form_is_the_round(K):
    wl = tiny.coef_workload(K=K)
    prog, flops = _round_cost(tiny.COEF, wl, warm=True)
    fam = harness.family(tiny.COEF)
    assert flops == fam.model_flops(tiny.COEF, wl, prog["problem"]) + fam.mixing_flops(tiny.COEF, wl, prog["problem"])


@pytest.mark.parametrize("K,batch,seq,layers,warm", [(2, 2, 16, 2, True), (3, 1, 32, 2, False), (2, 2, 16, 1, False)])
def test_lm_closed_form_plus_recompute_is_the_round(K, batch, seq, layers, warm):
    config = {**tiny.LM, "model": {**tiny.LM["model"], "num_hidden_layers": layers}}
    wl = tiny.lm_workload(K=K, batch=batch, seq_len=seq)
    _, flops = _round_cost(config, wl, warm)
    mdl, m, T = config["model"], wl["nodes"], batch * seq
    D, F, V, H = mdl["hidden_size"], mdl["intermediate_size"], mdl["vocab_size"], mdl["num_attention_heads"]
    layer = 2 * T * D * 3 * D + 2 * T * D * D + 3 * 2 * T * D * F + 2 * 2 * batch * H * seq * seq * (D // H)
    head = 2 * T * D * V
    extra = flops - lm_bilevel.model_flops(config, wl) - lm_bilevel.mixing_flops(config, wl) - 2 * m * layers * layer
    assert extra % (m * head) == 0
    assert K + 3 <= extra // (m * head) <= K + 5
