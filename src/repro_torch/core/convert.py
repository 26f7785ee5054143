"""Carry arrays and states across from the JAX reference.

``from_numpy(tree, device)`` turns numpy (or any ``np.asarray``-able, e.g.
JAX) arrays, dicts of them, and ``C2DFBState`` / ``InnerState`` shaped
tuples from the reference into the port's tensors and states, so a test
can start both packages from the same x0, y0 or mid-run state.  States are
recognized by their field names; this module imports nothing of the
reference.  ``to_numpy`` goes the other way for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.c2dfb import C2DFBState
from repro_torch.core.inner_loop import InnerState
from repro_torch.core.types import Tree, tree_map


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_numpy(tree, device: str | torch.device = "cpu"):
    """Reference arrays / dicts / states -> the port's tensors / states."""
    fields = getattr(type(tree), "_fields", None)
    if fields == C2DFBState._fields:
        return C2DFBState(
            x=from_numpy(tree.x, device),
            s_x=from_numpy(tree.s_x, device),
            u_prev=from_numpy(tree.u_prev, device),
            inner_y=from_numpy(tree.inner_y, device),
            inner_z=from_numpy(tree.inner_z, device),
            t=int(np.asarray(tree.t)),
        )
    if fields == InnerState._fields:
        return InnerState(*(from_numpy(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def to_numpy(tree: Tree):
    """The port's tensors (or a dict of them) -> float32/int numpy arrays."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
