"""The paper's technique on the framework's LM architectures
(``repro.core.lm_bilevel``'s counterpart): decentralized
hyper-representation learning, with the UPPER level x the backbone
(embedding and blocks) and the LOWER level y the task head (final norm and
LM head), one bilevel node a decentralized data shard.

`make_lm_bilevel` returns a `BilevelProblem` wired to the transformer's
forward pass, so the whole C2DFB machinery (compressed reference-point
inner loops, gradient tracking, gossip, transports) runs unchanged on
transformers.  Its ``f`` and ``g`` take node-stacked trees and data and
return the (m,) per-node losses; the node axis is a batch axis of every
product (`repro_torch.models.layers`), where the reference vmaps a
per-node loss.
"""

from __future__ import annotations

import torch

from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.types import broadcast_nodes, tree_leaves
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.models.transformer import forward_hidden, init_lm_params

HEAD_KEYS = ("final_norm", "lm_head")


def split_params(params: dict) -> tuple[dict, dict]:
    """(backbone x, head y): the bilevel split."""
    x = {k: v for k, v in params.items() if k not in HEAD_KEYS}
    y = {k: v for k, v in params.items() if k in HEAD_KEYS}
    return x, y


def merge_params(x: dict, y: dict) -> dict:
    out = dict(x)
    out.update(y)
    return out


def _loss(cfg, params, tokens, labels, ridge, y=None) -> torch.Tensor:
    """Each node's loss (m,): the chunked cross-entropy of the model, plus
    ``ridge`` times the squared norm of ``y`` (in f32) when given, plus 0.01
    times the auxiliary loss."""
    hidden, aux = forward_hidden(params, cfg, tokens)
    loss = chunked_cross_entropy(
        hidden, labels, params["lm_head"], chunk=min(256, tokens.shape[2]), logit_cap=cfg.logit_softcap,
    )
    if ridge and y is not None:
        reg = sum(torch.sum(torch.square(v.to(torch.float32)).reshape(v.shape[0], -1), dim=1)
                  for v in tree_leaves(y))
        loss = loss + ridge * reg
    return loss + 0.01 * aux


def make_lm_bilevel(cfg, data_train: dict, data_val: dict, m: int, ridge: float = 1e-4) -> BilevelProblem:
    """data_*: node-stacked dicts {"tokens": (m, B, S), "labels": (m, B, S)}."""
    assert not cfg.tie_embeddings, "bilevel head split needs a separate lm_head"

    def f(x, y, d):  # upper level: the validation loss of the full model
        return _loss(cfg, merge_params(x, y), d["tokens"], d["labels"], 0.0)

    def g(x, y, d):  # lower level: the training loss plus a ridge on the head
        return _loss(cfg, merge_params(x, y), d["tokens"], d["labels"], ridge, y=y)

    return BilevelProblem(f=f, g=g, data_f=data_val, data_g=data_train, m=m)


def init_node_params(cfg, generator: torch.Generator, m: int) -> tuple[dict, dict]:
    """Node-stacked (x0, y0): one model drawn from ``generator`` (on its
    device), split and copied to every node."""
    params = init_lm_params(cfg, generator)
    x, y = split_params(params)
    return broadcast_nodes(x, m), broadcast_nodes(y, m)
