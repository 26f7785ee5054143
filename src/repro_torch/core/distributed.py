"""The rank-level C2DFB inner loop (``repro.core.distributed``'s
counterpart): each node's state is one rank, its gossip realized as
neighbour shifts (ring, two-hop, torus) or the all-gather fallback, its
compression applied rank-locally.

The reference runs this under ``shard_map`` with one node per mesh device.
Here a rank is one row of the node-stacked tensors on the run's device; the
exchanges are `repro_torch.core.gossip`'s rank-level engines, and a rank's
gradient is ``grad_fn_local`` on its own state and data slice (vmapped over
the ranks, as ``shard_map`` maps it).  The node-stacked simulator
(`repro_torch.core.inner_loop`) is the reference this engine is held to.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import mix_delta_shard
from repro_torch.core.inner_loop import InnerState, inner_apply
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, tree_map


def compress_local(compressor: Compressor, generator, tree: Tree) -> Tree:
    """Rank-local compression: each rank compresses its own slice (leaf by
    leaf, each leaf rank by rank), so a stochastic compressor draws each
    rank's samples on their own, where the reference decorrelates the
    ranks with ``fold_in(key, rank)``."""
    return tree_map(lambda v: torch.stack([compressor(v[r], generator) for r in range(v.shape[0])]), tree)


def inner_step_shard(
    state: InnerState,
    generator,
    grad_fn: Callable[[Tree], Tree],
    topo: Topology,
    compressor: Compressor,
    gamma: float,
    eta: float,
) -> InnerState:
    """One Algorithm-2 step on every rank: `inner_loop.inner_apply` with the
    rank-level mixes of the references and rank-local compression.
    ``grad_fn`` maps the ranks' stacked iterates to their stacked gradients
    (each rank's from its own data shard)."""
    mixes = mix_delta_shard(topo, state.d_hat), mix_delta_shard(topo, state.s_hat)
    new_state, _ = inner_apply(state, generator, grad_fn, compressor, gamma, eta, *mixes, compress=compress_local)
    return new_state


def make_sharded_inner_loop(
    mesh,
    topo: Topology,
    grad_fn_local: Callable,
    compressor: Compressor,
    gamma: float,
    eta: float,
    K: int,
):
    """Returns ``fn(state, generator, data) -> state``: K compressed-GT
    steps with rank-level gossip on ``mesh`` (a
    `repro_torch.transport.NodeMesh` of topo.m ranks).  ``state`` and
    ``data`` are node-stacked (leading axis m); each rank gets its slice on
    the mesh's device.  ``grad_fn_local(d, data)`` is ONE rank's gradient
    at its iterate ``d`` on its data slice (no node axis), mapped over the
    ranks."""
    if mesh.m != topo.m:
        raise ValueError(f"mesh has {mesh.m} ranks but the topology has {topo.m} nodes")
    grad_ranks = torch.func.vmap(grad_fn_local)

    def fn(state: InnerState, generator, data: Tree) -> InnerState:
        state = InnerState(*(tree_map(lambda v: v.to(mesh.device), part) for part in state))
        data = tree_map(lambda v: v.to(mesh.device), data)
        gfn = lambda d: grad_ranks(d, data)  # noqa: E731
        for _ in range(K):
            state = inner_step_shard(state, generator, gfn, topo, compressor, gamma, eta)
        return state

    return fn
