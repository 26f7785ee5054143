"""PyTorch/CUDA port of the C2DFB system (the JAX package ``repro`` is the
reference).

The layout mirrors ``repro``: ``core`` (trees, topology, gossip, oracles,
compressors, Algorithm 2 inner loop, Algorithm 1 outer loop), ``data``
(the paper's two tasks), ``kernels`` (hand-written Hopper kernels with
plain PyTorch versions beside them), ``net`` (exact wire codecs, the
network fabric, topology schedules), ``obs`` (telemetry), ``async_gossip``
(the eager asynchronous engine) and ``transport`` (the simulated
transport the async scheduler reads arrivals through).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit ``device="cpu"`` they raise.  Importing this
package imports neither ``jax`` nor anything of ``repro``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present — there is no silent CPU fallback; pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the host'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
