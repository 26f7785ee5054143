"""Gossip mixing engines (``repro.core.gossip``'s counterpart).

Two interchangeable implementations of the consensus operator
``mix_delta(X)[i] = sum_j w_ij (X_j - X_i)``:

* ``dense`` — node-stacked matmul against (W - I).  Works for any graph;
  the simulator form.
* the rank-level engines — what each rank computes from what it RECEIVES.
  A rank is one row of the node-stacked tensor on the run's device.  For
  static shift-structured topologies (ring, two-hop, torus) the exchange
  is a handful of neighbour shifts: "rank r receives from rank r - shift"
  is ``torch.roll(v, shift, dims=0)``, a device copy of exactly the
  payload's bytes (the reference's ``lax.ppermute``).  For general graphs
  every rank gathers every slice (``lax.all_gather``); the gathered table
  is the same for every rank, so one stacked table serves them all, and
  rank r mixes with its row of W - I against it.

Each exchange reports what one rank receives to the open round-cost
counters (`repro_torch.obs.compute.record_collective`), under the
reference's collective kind: a shift (`shift_tree`) one rank's slice of
each leaf, a gather (`gather_tree`) the m slices.  The counters only
observe.

Every engine mixes in f32 and emits at the leaf's dtype.  (The reference's
``mix_delta_ppermute`` accumulates at the leaf's dtype, its device
transport in f32; the two agree for f32 leaves.)

The mixing *step* used by the algorithms is ``x <- x + gamma * mix_delta(x)``,
i.e. x <- (I + gamma (W - I)) x, whose spectral gap is >= gamma * rho (paper
Proposition 5).
"""

from __future__ import annotations

import torch

from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, tree_leaves, tree_map
from repro_torch.obs.compute import record_collective
from repro_torch.obs.timeline import MIX, layer


def w_minus_i(W: torch.Tensor) -> torch.Tensor:
    """W - I in W's dtype (f32 for the mixing)."""
    return W - torch.eye(W.shape[0], dtype=W.dtype, device=W.device)


def mix_delta_dense(W: torch.Tensor, x: Tree) -> Tree:
    """sum_j w_ij (x_j - x_i) for node-stacked trees (leading axis m)."""

    def leaf(v):
        flat = v.reshape(v.shape[0], -1).to(torch.float32)
        out = W_minus_I @ flat
        # mixing arithmetic in f32, emitted at the parameter dtype (bf16 LMs)
        return out.reshape(v.shape).to(v.dtype)

    with layer(MIX):
        W_minus_I = w_minus_i(W)
        return tree_map(leaf, x)


def mix_step_dense(W: torch.Tensor, gamma, x: Tree) -> Tree:
    """x + gamma * sum_j w_ij (x_j - x_i)."""
    delta = mix_delta_dense(W, x)
    return tree_map(lambda v, d: v + gamma * d, x, delta)


# ---------------------------------------------------------------------------
# rank-level engines
# ---------------------------------------------------------------------------


def shift_ranks(v: torch.Tensor, shift: int) -> torch.Tensor:
    """What every rank receives from rank ``r - shift``: row r of the result
    is row ``(r - shift) % m`` of ``v``."""
    return torch.roll(v, shifts=shift, dims=0)


def shift_tree(tree: Tree, shift: int) -> Tree:
    """`shift_ranks` on every leaf of a node-stacked tree: the reference's
    collective permute, one rank's slice of each leaf a rank."""
    record_collective("collective-permute", tree_leaves(tree))
    return tree_map(lambda v: shift_ranks(v, shift), tree)


def gather_tree(tree: Tree) -> Tree:
    """What every rank holds after gathering a node-stacked tree: the
    stacked tree itself, the same table for every rank (the reference's
    all-gather, the m slices of each leaf a rank)."""
    record_collective("all-gather", tree_leaves(tree))
    return tree


def rows_against_table(W_minus_I: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rank r's row of ``W - I`` against the gathered (m, ...) ``table``, for
    every r: one batched product whose batch r reads the whole table, as
    each rank of the reference reads its own gathered copy."""
    m = table.shape[0]
    flat = table.reshape(m, -1).to(torch.float32)
    out = torch.bmm(W_minus_I.unsqueeze(1), flat.unsqueeze(0).expand(m, m, flat.shape[1]))
    return out.reshape(table.shape)


def mix_received(schedule, received: tuple, own: Tree) -> Tree:
    """Each rank's neighbour difference from what it received, one tree a
    schedule shift: sum of w * (received - own), shift by shift in f32
    (the reference's per-rank accumulation), emitted at own's dtype."""

    def leaf(o, *rs):
        of = o.to(torch.float32)
        acc = torch.zeros_like(of)
        for (_, w), r in zip(schedule, rs):
            acc = acc + w * (r.to(torch.float32) - of)
        return acc.to(o.dtype)

    return tree_map(leaf, own, *received)


def mix_gathered(W_minus_I: torch.Tensor, table: Tree, own: Tree) -> Tree:
    """Each rank's row of W - I against the gathered ``table`` (f32),
    emitted at own's dtype."""
    return tree_map(lambda t, o: rows_against_table(W_minus_I, t).to(o.dtype), table, own)


def mix_delta_ppermute(topo: Topology, x: Tree) -> Tree:
    """Rank-level neighbour difference for shift-structured topologies:
    every rank receives its neighbours' slices by the schedule's shifts and
    mixes them (`mix_received`)."""
    if topo.ppermute_schedule is None:
        raise ValueError(f"topology {topo.name} has no static ppermute schedule")
    schedule = topo.ppermute_schedule
    with layer(MIX):
        return mix_received(schedule, tuple(shift_tree(x, s) for s, _ in schedule), x)


def mix_delta_allgather(topo: Topology, x: Tree) -> Tree:
    """General-graph fallback: every rank gathers every slice and reduces
    with its row of W - I (`mix_gathered`)."""
    with layer(MIX):
        W = torch.as_tensor(topo.W, dtype=torch.float32, device=tree_leaves(x)[0].device)
        return mix_gathered(w_minus_i(W), gather_tree(x), x)


def mix_delta_shard(topo: Topology, x: Tree) -> Tree:
    """mix_delta(x) by the rank-level engine the topology allows: neighbour
    shifts where it has a schedule, else the gather."""
    if topo.ppermute_schedule is not None:
        return mix_delta_ppermute(topo, x)
    return mix_delta_allgather(topo, x)


def mix_step_shard(topo: Topology, gamma, x: Tree) -> Tree:
    """x + gamma * mix_delta(x) by the rank-level engine (`mix_delta_shard`)."""
    delta = mix_delta_shard(topo, x)
    return tree_map(lambda v, d: v + gamma * d, x, delta)

