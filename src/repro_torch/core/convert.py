"""Carry arrays and states across from the JAX reference.

``from_numpy(tree, device)`` turns numpy (or any ``np.asarray``-able, e.g.
JAX) arrays, dicts and lists of them (an LM's parameter tree), and the reference's state tuples (C2DFB's
``C2DFBState`` / ``InnerState`` and the baselines' ``MDBOState``,
``MADSBOState``, ``NCInnerState``, ``C2DFBncState``, ``F2SAState``; the
optimizers' ``OptState``, whose absent second moment is None) into the
port's tensors and states, so a test can start both packages from the same
x0, y0, mid-run state, optimizer state or decode caches (lists of dicts).  States are recognized by their class and field
names (C2DFBState and C2DFBncState share their fields); this module imports
nothing of the reference.  ``to_numpy`` goes the other way for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import C2DFBncState, F2SAState, MADSBOState, MDBOState, NCInnerState
from repro_torch.core.c2dfb import C2DFBState
from repro_torch.core.inner_loop import InnerState
from repro_torch.core.types import Tree, tree_map
from repro_torch.optim import OptState

_STATES = {
    (cls.__name__, cls._fields): cls
    for cls in (C2DFBState, InnerState, MDBOState, MADSBOState, NCInnerState, C2DFBncState, F2SAState, OptState)
}
_COUNTERS = ("t", "step")  # the states' integer round / step counters


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_numpy(tree, device: str | torch.device = "cpu"):
    """Reference arrays / dicts / states -> the port's tensors / states."""
    if tree is None:
        return None
    cls = _STATES.get((type(tree).__name__, getattr(type(tree), "_fields", None)))
    if cls is not None:
        return cls(*(
            int(np.asarray(v)) if f in _COUNTERS else from_numpy(v, device) for f, v in zip(cls._fields, tree)
        ))
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_numpy(v, device) for v in tree]
    return _tensor(tree, device)


def to_numpy(tree: Tree):
    """The port's tensors (or a dict or list of them, or a state) ->
    float32/int numpy arrays (a state's counters stay integers)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v if f in _COUNTERS else to_numpy(v) for f, v in zip(tree._fields, tree)))

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
