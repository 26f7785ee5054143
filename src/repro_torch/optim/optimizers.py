"""Optimizers over parameter trees (``repro.optim.optimizers``'s
counterpart): SGD with momentum and AdamW, global-norm clipping.

The optimizer state mirrors the parameter tree leaf for leaf; the moments
are f32 unless ``moment_dtype`` says otherwise (bf16 moments for the
largest models, as in the reference).

The reference's updates are functional: each returns new parameters and
moments and keeps the old ones until the new exist.  At phi3-mini's width
that holds two extra copies of the moments (30.6 GB in f32) beside the
gradients, which one 80 GB card cannot hold.  The updates here go LEAF BY
LEAF and overwrite each leaf in place (under ``torch.no_grad``): a leaf's
temporaries (at most two f32 tensors of its size) are freed before the
next leaf starts.  They return the same tensors they were given, updated.
Each update does the reference's arithmetic in its order and rounding: f32
operations, one rounding each, then a cast back to the parameter's dtype;
Python numbers act as the reference's weakly typed scalars (rounded to the
tensor's dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.types import tree_leaves, tree_map


class OptState(NamedTuple):
    step: int  # updates taken
    m: Any  # first moment / momentum
    v: Any  # second moment (None for SGD-M)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` IN PLACE to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping, an f32 0-dim tensor).  The
    norm is the square root of the sum, leaf by leaf in flattening order,
    of each leaf's sum of squares in f32; each leaf is multiplied by the
    f32 scale in f32 and cast back, as the reference's ``(g *
    scale).astype(g.dtype)``."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(_f32(g).square_().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(_f32(g).mul_(scale))
    return grads, gnorm


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A new f32 copy of ``t`` (one temporary of its size)."""
    return t.to(torch.float32, copy=True)


def _divisor(c: float, like: torch.Tensor) -> torch.Tensor:
    """``c`` as an f32 tensor on ``like``'s device: a Python divisor would
    make the card multiply by its reciprocal, where the reference divides."""
    return torch.full((), c, dtype=torch.float32, device=like.device)


def _zeros(params, dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)


# -- SGD with momentum -------------------------------------------------------


def sgdm_init(params, moment_dtype=torch.float32) -> OptState:
    return OptState(step=0, m=_zeros(params, moment_dtype), v=None)


@torch.no_grad()
def sgdm_update(grads, state: OptState, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
    """m <- momentum m + g (in the moments' dtype); p <- p (1 - lr wd) - lr m
    in f32, cast to p's dtype.  Updates ``params`` and ``state.m`` in place
    and returns them."""
    for p, m, g in zip(tree_leaves(params), tree_leaves(state.m), tree_leaves(grads)):
        m.mul_(momentum).add_(g.to(m.dtype))
        new = _f32(p).mul_(1 - lr * weight_decay)
        t = _f32(m).mul_(lr)
        new.sub_(t)
        del t
        p.copy_(new)
        del new
    return params, OptState(step=state.step + 1, m=state.m, v=None)


# -- AdamW -------------------------------------------------------------------


def adamw_init(params, moment_dtype=torch.float32) -> OptState:
    return OptState(step=0, m=_zeros(params, moment_dtype), v=_zeros(params, moment_dtype))


def _bias_correction(b: float, step: int) -> float:
    """1 - b ** step in f32, as the reference's ``1 - b1 ** step.astype(f32)``."""
    return float(np.float32(1) - np.float32(b) ** np.float32(step))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2) g^2 (in the moments'
    dtype); p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p) in f32, cast to
    p's dtype, with m_hat = m / (1 - b1^t) and v_hat = v / (1 - b2^t).
    Leaf by leaf, in place; returns ``params`` and the new state."""
    step = state.step + 1
    c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.m), tree_leaves(state.v), tree_leaves(grads)):
        t = g.to(m.dtype, copy=True).mul_(1 - b1)
        m.mul_(b1).add_(t)
        del t
        t = g.to(v.dtype, copy=True).square_().mul_(1 - b2)
        v.mul_(b2).add_(t)
        del t
        den = _f32(v).div_(_divisor(c2, v)).sqrt_().add_(eps)
        delta = _f32(m).div_(_divisor(c1, m)).div_(den)
        del den
        t = _f32(p).mul_(weight_decay)
        delta.add_(t)
        del t
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(_f32(p).sub_(delta))
        del delta
    return params, OptState(step=step, m=state.m, v=state.v)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str


def make_optimizer(name: str, moment_dtype=torch.float32) -> Optimizer:
    if name in ("sgd", "sgdm"):
        return Optimizer(init=lambda p: sgdm_init(p, moment_dtype), update=sgdm_update, name="sgdm")
    if name == "adamw":
        return Optimizer(init=lambda p: adamw_init(p, moment_dtype), update=adamw_update, name="adamw")
    raise ValueError(name)
