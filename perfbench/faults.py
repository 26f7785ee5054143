"""Faults planted in the program, for the check's calibration and its tests
only (the benchmark's own runs plant none).  Each takes the built program
(``problem``, ``topo``, ``cfg``, ``x0``, ``y0``, ``W``, ``round``) and
returns it broken:

* ``frozen``: a round that returns its state unchanged;
* ``half_batch``: every oracle reads the first half of each node's rows,
  its mean taken over those;
* ``no_exchange``: the gossip between nodes left out (W = I, so every
  mixing term is zero);
* ``altered_answer``: every compressed message altered where it is made:
  node 0's largest entry of each leaf negated.

and two wrong step rules, of the updates that a gap of norms alone might
not see, since each moves a leaf by the right amount the wrong way:

* ``outer_step_flipped``: the outer update adds eta_out s_x to x where it
  should take it away;
* ``inner_step_flipped``: each inner step adds eta s to d where it should
  take it away.
"""

from __future__ import annotations

import dataclasses

import torch

NAMES = ("frozen", "half_batch", "no_exchange", "altered_answer")
STEP_FAULTS = ("outer_step_flipped", "inner_step_flipped")


def _frozen(prog: dict) -> dict:
    inner = prog["round"]

    def stuck(state, *args, **kwargs):
        _, metrics = inner(state, *args, **kwargs)
        return state, metrics

    return {**prog, "round": stuck}


def _half(tree):
    if isinstance(tree, dict):
        return {k: _half(v) for k, v in tree.items()}
    return tree[:, : tree.shape[1] // 2].contiguous()


def _half_batch(prog: dict) -> dict:
    p = prog["problem"]
    return {**prog, "problem": dataclasses.replace(p, data_f=_half(p.data_f), data_g=_half(p.data_g))}


def _no_exchange(prog: dict) -> dict:
    W = prog["W"]
    return {**prog, "W": torch.eye(W.shape[0], dtype=W.dtype, device=W.device)}


def _negate_largest(out: torch.Tensor) -> torch.Tensor:
    flat = out.reshape(out.shape[0], -1).clone()
    i = int(torch.argmax(flat[0].abs()))
    flat[0, i] = -flat[0, i]
    return flat.reshape(out.shape)


def _altered_answer(prog: dict) -> dict:
    cfg = prog["cfg"]
    base = type(cfg)

    class Altered(base):
        def make_compressor(self):
            comp = base.make_compressor(self)
            kind = type(comp)
            broken = type(f"Altered{kind.__name__}", (kind,), {
                "compress_nodes": lambda s, x, generator=None: _negate_largest(kind.compress_nodes(s, x, generator)),
            })
            return broken(**{f.name: getattr(comp, f.name) for f in dataclasses.fields(comp)})

    return {**prog, "cfg": Altered(**dataclasses.asdict(cfg))}


def _outer_step_flipped(prog: dict) -> dict:
    cfg = prog["cfg"]
    return {**prog, "cfg": dataclasses.replace(cfg, eta_out=-cfg.eta_out)}


def _inner_step_flipped(prog: dict) -> dict:
    cfg = prog["cfg"]
    return {**prog, "cfg": dataclasses.replace(cfg, eta_in=-cfg.eta_in)}


def plant(prog: dict, names) -> dict:
    for name in names:
        prog = {"frozen": _frozen, "half_batch": _half_batch, "no_exchange": _no_exchange,
                "altered_answer": _altered_answer, "outer_step_flipped": _outer_step_flipped,
                "inner_step_flipped": _inner_step_flipped}[name](prog)
    return prog
