"""Algorithm 2 — the compressed gradient-tracking inner loop ``IN``
(``repro.core.inner_loop``'s counterpart, synchronous path).

State per node (stacked over the leading node axis):
    d      current model (y or z)
    d_hat  reference point of the model (what neighbors believe we hold)
    s      gradient tracker
    s_hat  reference point of the tracker
    g_prev gradient at the previous iterate (tracking delta)

One step (paper Algorithm 2):
    d^{k+1}    = d^k + gamma * sum_j w_ij (dhat_j - dhat_i) - eta * s^k
    transmit   Q(d^{k+1} - dhat^k);   dhat^{k+1} = dhat^k + Q(.)
    s^{k+1}    = s^k + gamma * sum_j w_ij (shat_j - shat_i) + grad^{k+1} - grad^k
    transmit   Q(s^{k+1} - shat^k);   shat^{k+1} = shat^k + Q(.)

Key invariants (tested):
* mean dynamics are compression-free:  d_bar^{k+1} = d_bar^k - eta * s_bar^k  (Eq. 7)
* tracking:                            s_bar^k = (1/m) sum_i grad_i(d_i^k)   (Prop. 4)

Reference points and trackers PERSIST across outer rounds; because the
objective changes between rounds (x moved), ``refresh_tracker`` re-bases the
tracker with grad_new - grad_prev, which preserves the tracking invariant.

Every step builds new tensors; no state is updated in place, so a caller's
initial point survives a run.  ``inner_round_phases`` turns one loop into
the barrier phases the network fabric prices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import mix_delta_dense
from repro_torch.core.types import Tree, consensus_error, tree_leaves, tree_map, tree_sq_norm
from repro_torch.net.fabric import edge_list
from repro_torch.net.wire import codec_for, scan_tree_bytes


class InnerState(NamedTuple):
    d: Tree
    d_hat: Tree
    s: Tree
    s_hat: Tree
    g_prev: Tree


def compress_stacked(
    compressor: Compressor, generator, tree: Tree
) -> Tree:
    """Apply Q per node to every leaf of a node-stacked tree, leaves in
    sorted-key order (one ``compress_nodes`` call, so one draw, a leaf)."""
    return tree_map(lambda leaf: compressor.compress_nodes(leaf, generator), tree)


def inner_init(d0: Tree, grad_fn: Callable[[Tree], Tree]) -> InnerState:
    """Fresh state: references start at the true values (zero residual),
    tracker starts at the local gradient (standard GT init)."""
    g0 = grad_fn(d0)
    return InnerState(d=d0, d_hat=d0, s=g0, s_hat=g0, g_prev=g0)


def refresh_tracker(state: InnerState, grad_fn) -> InnerState:
    """Re-base the tracker after the objective changed (new outer x):
    s += grad_new(d) - grad_prev keeps s_bar == mean grad under the NEW
    objective, while reference points persist."""
    g_new = grad_fn(state.d)
    s = tree_map(lambda s_, gn, gp: s_ + gn - gp, state.s, g_new, state.g_prev)
    return state._replace(s=s, g_prev=g_new)


def inner_transmit(
    compressor: Compressor, generator, value: Tree, ref: Tree, compress=compress_stacked
) -> Tree:
    """The transmit half of a step: the compressed residual ``Q(value - ref)``,
    the per-edge message payload.  ``compress(compressor, generator, tree)``
    applies Q to a node-stacked tree (`compress_stacked` by default)."""
    resid = tree_map(torch.sub, value, ref)
    return compress(compressor, generator, resid)


def inner_apply(
    state: InnerState,
    generator,
    grad_fn: Callable[[Tree], Tree],
    compressor: Compressor,
    gamma: float,
    eta: float,
    mix_d: Tree,
    mix_s: Tree,
    compress=compress_stacked,
) -> tuple[InnerState, tuple[Tree, Tree]]:
    """One inner step with the MIXING DELTAS supplied by the caller; also
    returns the two transmitted messages ``(q_d, q_s)``.  ``compress`` is
    `inner_transmit`'s (the rank-level engine compresses rank by rank)."""
    # (1) model update: mix on REFERENCES, descend along tracker
    d_new = tree_map(lambda d, md, s: d + gamma * md - eta * s, state.d, mix_d, state.s)

    # (2) reference update via compressed residual (this is the transmission)
    q_d = inner_transmit(compressor, generator, d_new, state.d_hat, compress)
    d_hat_new = tree_map(torch.add, state.d_hat, q_d)

    # (3) tracker update: mix on tracker references + gradient delta
    g_new = grad_fn(d_new)
    s_new = tree_map(
        lambda s, ms, gn, gp: s + gamma * ms + gn - gp, state.s, mix_s, g_new, state.g_prev
    )

    # (4) tracker reference update via compressed residual
    q_s = inner_transmit(compressor, generator, s_new, state.s_hat, compress)
    s_hat_new = tree_map(torch.add, state.s_hat, q_s)

    new_state = InnerState(d=d_new, d_hat=d_hat_new, s=s_new, s_hat=s_hat_new, g_prev=g_new)
    return new_state, (q_d, q_s)


def inner_step(
    state: InnerState,
    generator,
    grad_fn: Callable[[Tree], Tree],
    W: torch.Tensor,
    compressor: Compressor,
    gamma: float,
    eta: float,
) -> InnerState:
    """Synchronous step: mix on the current references, then apply."""
    mix_d = mix_delta_dense(W, state.d_hat)
    mix_s = mix_delta_dense(W, state.s_hat)
    new_state, _ = inner_apply(state, generator, grad_fn, compressor, gamma, eta, mix_d, mix_s)
    return new_state


def inner_loop(
    state: InnerState,
    generator,
    grad_fn: Callable[[Tree], Tree],
    W: torch.Tensor,
    compressor: Compressor,
    gamma: float,
    eta: float,
    K: int,
    fabric=None,
    round_idx: int = 0,
    transport=None,
    mixer: Callable[[InnerState], tuple[Tree, Tree]] | None = None,
) -> tuple[InnerState, dict]:
    """Run K compressed-GT steps; returns final state + metrics.

    ``msg_bytes`` is the exact wire bytes of the loop's K x 2 messages
    (per-node broadcast accounting), counted on the device from the actual
    payloads by `repro_torch.net.wire.scan_tree_bytes`.

    ``mixer(state)`` returns each step's mixing deltas ``(mix_d, mix_s)``
    from the step's input state; by default the dense mix on the current
    references with ``W``.  The async engine passes
    `repro_torch.async_gossip.mixing.DelayedMixer`, which mixes age-gated
    reference histories and advances them itself.

    With a ``fabric`` (a `repro_torch.net.fabric.NetworkFabric`), metrics
    additionally carry ``wire_bytes`` (int, codec-measured on this loop's
    final residuals) and ``sim_seconds`` (the simulated wall clock of the K
    barrier phases x 2 messages), priced as round ``round_idx``.
    ``transport`` (a `repro_torch.transport.Transport`) prices the loop
    through the transport's fabric-mirroring face instead.  The
    measurement draws after the K steps' draws: the d message, then the s
    message, where the reference draws them from ``split(key)`` of the
    loop's own key."""
    fabric = pricing_face(fabric, transport)
    if mixer is None:
        mixer = lambda st: (mix_delta_dense(W, st.d_hat), mix_delta_dense(W, st.s_hat))  # noqa: E731
    msg_bytes = None
    for _ in range(K):
        # the mixes are the call's temporaries: freed before the next step's
        state, (q_d, q_s) = inner_apply(state, generator, grad_fn, compressor, gamma, eta, *mixer(state))
        nbytes = scan_tree_bytes(compressor, q_d) + scan_tree_bytes(compressor, q_s)
        msg_bytes = nbytes if msg_bytes is None else msg_bytes + nbytes
    if msg_bytes is None:
        msg_bytes = torch.zeros((), dtype=torch.int64, device=tree_leaves(state.d)[0].device)
    metrics = {
        "consensus_err": consensus_error(state.d),
        "compress_err": tree_sq_norm(tree_map(torch.sub, state.d, state.d_hat)),
        "tracker_consensus_err": consensus_error(state.s),
        "msg_bytes": msg_bytes,
    }
    if fabric is not None:
        phases, labels = inner_round_phases(state, compressor, fabric.topo, generator, K)
        rep = fabric.simulate_round(phases, round_idx, labels=labels)
        metrics["wire_bytes"] = rep["wire_bytes"]
        metrics["sim_seconds"] = rep["sim_seconds"]
    return state, metrics


def pricing_face(fabric, transport, topo=None):
    """What a loop or round is priced on: ``fabric``, or ``transport`` (a
    transport mirrors the fabric's pricing API), bound to ``topo`` where
    one is given."""
    if transport is None:
        return fabric
    if fabric is not None:
        raise ValueError("pass fabric OR transport, not both")
    return transport if topo is None else transport.bind(topo)


def inner_message_bytes(
    state: InnerState, compressor: Compressor, generator=None
) -> tuple[list[int], list[int]]:
    """Exact per-node wire bytes of one inner step's two transmissions,
    measured by serializing Q(d - d_hat) and Q(s - s_hat) with the codec
    (current residuals; sizes are steady once residuals are nonzero)."""
    codec = codec_for(compressor)
    out = []
    for a, b in ((state.d, state.d_hat), (state.s, state.s_hat)):
        q = inner_transmit(compressor, generator, a, b)
        m = tree_leaves(q)[0].shape[0]
        out.append([codec.tree_bytes(tree_map(lambda v: v[i], q)) for i in range(m)])
    return out[0], out[1]


def inner_round_phases(
    state: InnerState, compressor: Compressor, topo, generator, K: int
) -> tuple[list, list]:
    """K steps x (d-residual, s-residual) barrier phases as per-edge byte
    dicts for ``NetworkFabric.simulate_round``: each node's two messages
    are measured once by the codec (one pack launch per node per message
    for the block-sparse codec) and priced on every out-edge."""
    bytes_d, bytes_s = inner_message_bytes(state, compressor, generator)
    edges = edge_list(topo)
    phase_d = {(i, j): bytes_d[i] for (i, j) in edges}
    phase_s = {(i, j): bytes_s[i] for (i, j) in edges}
    phases, labels = [], []
    for k in range(K):
        phases += [phase_d, phase_s]
        labels += [f"in{k}/d", f"in{k}/s"]
    return phases, labels


def inner_wire_bytes_per_round(
    compressor: Compressor, single_node_tree: Tree, K: int, m: int
) -> float:
    """Analytic wire bytes one round of IN puts on the network (all m nodes):
    each node transmits Q(d-resid) and Q(s-resid) once per step."""
    per_msg = compressor.tree_wire_bytes(single_node_tree)
    return 2.0 * per_msg * K * m
