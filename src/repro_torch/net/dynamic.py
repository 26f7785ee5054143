"""Time-varying topology schedules for gossip mixing (``repro.net.dynamic``'s
counterpart, numpy only: graphs are edge lists, where the reference builds
networkx graphs).

A ``TopologySchedule`` yields one mixing matrix per round — always symmetric
doubly stochastic (Metropolis weights on the round's active subgraph), so
every schedule step is a valid Assumption-1 gossip operator even when the
instantaneous graph is disconnected.  Convergence then rests on joint
(B-)connectivity across windows of rounds, the standard time-varying-graph
condition; ``BConnectedSchedule`` realizes it constructively and
``is_jointly_connected`` checks it for sampled schedules.

Schedules plug into the algorithms through the ``W`` override of
``c2dfb_round`` / the ``schedule`` argument of ``c2dfb.run`` (round t of
the run takes the stacked array's matrix t), and into the fabric through
``active_edges``.

Edge order.  The random schedules draw one value per base edge, or index
the base edge list, so their draws follow the edge order.  The reference
walks ``G.edges()`` of a networkx graph whose nodes 0..m-1 were added
first and whose edges were added from the sorted neighbour tuples; that
yields the pairs (i, j) with i < j in ascending order, which is what
``base_edges`` returns (pinned against networkx on a non-ring topology in
tests/test_torch_net.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Topology, _connected, metropolis_weights
from repro_torch.net.fabric import NetworkFabric


class TopologySchedule:
    """One mixing matrix per round over a fixed node set."""

    base: Topology

    def weights(self, t: int) -> np.ndarray:
        """(m, m) symmetric doubly-stochastic matrix for round t."""
        raise NotImplementedError

    def active_edges(self, t: int) -> tuple[tuple[int, int], ...]:
        """Directed edges carrying traffic in round t (derived from W via
        the shared ``active_edge_masks`` threshold)."""
        W = self.weights(t)
        m = W.shape[0]
        off = active_edge_masks(W[None])[0]
        return tuple((i, j) for i in range(m) for j in range(m) if off[i, j])

    def stack(self, T: int) -> np.ndarray:
        """(T, m, m) array of per-round matrices."""
        return np.stack([self.weights(t) for t in range(T)])


@dataclasses.dataclass(frozen=True)
class StaticSchedule(TopologySchedule):
    """The degenerate schedule: the base graph every round.  Running any
    algorithm with it must be bit-identical to the schedule-free path
    (tested in tests/test_torch_net.py)."""

    base: Topology

    def weights(self, t: int) -> np.ndarray:
        return self.base.W


def base_edges(topo: Topology) -> list[tuple[int, int]]:
    """The undirected base edges (i, j), i < j, ascending: the order of the
    reference's ``G.edges()`` (see the module docstring)."""
    return [(i, j) for i in range(topo.m) for j in sorted(topo.neighbors[i]) if j > i]


@dataclasses.dataclass(frozen=True)
class LinkDropoutSchedule(TopologySchedule):
    """Each base edge fails independently with probability ``p_drop`` each
    round (flaky links).  Deterministic given ``seed``."""

    base: Topology
    p_drop: float = 0.2
    seed: int = 0

    def weights(self, t: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, t))
        keep = [e for e in base_edges(self.base) if rng.random() >= self.p_drop]
        return metropolis_weights(keep, self.base.m)


@dataclasses.dataclass(frozen=True)
class RandomEdgeSchedule(TopologySchedule):
    """Uniformly sample ``n_edges`` of the base graph per round (randomized
    gossip / edge subsampling to cut per-round traffic)."""

    base: Topology
    n_edges: int = 4
    seed: int = 0

    def weights(self, t: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, t))
        edges = base_edges(self.base)
        pick = rng.choice(
            len(edges), size=min(self.n_edges, len(edges)), replace=False
        )
        return metropolis_weights([edges[k] for k in pick], self.base.m)


@dataclasses.dataclass(frozen=True)
class LatencyDropoutSchedule(TopologySchedule):
    """Fabric-aware schedule: an edge sits out a round when its SIMULATED
    arrival time exceeds ``deadline_s`` — the link model *causes* the
    topology dynamics instead of merely pricing them (the `dynamic`↔`fabric`
    loop from the ROADMAP).

    Per round t, each undirected base edge's one-way delivery time is priced
    by the fabric's link model on a ``payload_bytes`` message —
    transfer + propagation + a per-(seed, round, edge) jitter draw, exactly
    the fabric's per-message arrival query.  Edges that would miss the
    deadline are deactivated for the round; Metropolis weights on the
    survivors keep every round a valid gossip operator.  Deterministic given
    the fabric's seed (stream-separated from the fabric's own draws, so
    pricing the resulting rounds does not perturb the schedule).
    """

    base: Topology
    fabric: NetworkFabric = None
    deadline_s: float = 0.05
    payload_bytes: int = 4096

    def __post_init__(self):
        if self.fabric is None:
            raise ValueError(
                "LatencyDropoutSchedule needs the NetworkFabric whose link "
                "model drives the dropout"
            )

    def weights(self, t: int) -> np.ndarray:
        rng = self.fabric.round_rng(t, stream=0x1A7)
        keep = []
        for e in base_edges(self.base):
            arrive = self.fabric.message_arrival(0.0, self.payload_bytes, rng)
            if arrive <= self.deadline_s:
                keep.append(e)
        return metropolis_weights(keep, self.base.m)


@dataclasses.dataclass(frozen=True)
class BConnectedSchedule(TopologySchedule):
    """Round-robin partition of the base edges into ``B`` groups; round t
    activates group t mod B, so the union over any B consecutive rounds is
    the full (connected) base graph — the classic B-connected sequence."""

    base: Topology
    B: int = 2

    def weights(self, t: int) -> np.ndarray:
        edges = base_edges(self.base)
        return metropolis_weights(
            [e for k, e in enumerate(edges) if k % self.B == t % self.B], self.base.m
        )


#: Weight threshold below which an off-diagonal entry counts as "no edge"
#: — shared by every activity derivation in this module so the engine's
#: simulated edge set can never disagree with the fabric-facing one.
ACTIVE_EDGE_EPS = 1e-12


def validate_schedule_stack(
    Ws: np.ndarray, T: int, m: int, atol: float = 1e-8, base=None
) -> np.ndarray:
    """Check a stacked (T, m, m) schedule before it drives a run; raises a
    ValueError naming the exact defect (`c2dfb.run` calls this so a
    malformed schedule fails loudly, not with a shape error three layers
    down a round).  ``base`` (a Topology) also
    rejects rounds activating edges OUTSIDE the base graph — the
    scheduler's timelines, lag bookkeeping and wire pricing only cover
    base edges, so a phantom edge would mix at permanent zero age for
    free."""
    Ws = np.asarray(Ws, dtype=np.float64)
    if Ws.ndim != 3 or Ws.shape[0] != T or Ws.shape[1:] != (m, m):
        raise ValueError(
            f"schedule stack has shape {Ws.shape}; expected ({T}, {m}, {m}) "
            f"— one symmetric mixing matrix per round for {m} nodes"
        )
    base_mask = None
    if base is not None:
        base_mask = np.zeros((m, m), dtype=bool)
        for i, neigh in enumerate(base.neighbors):
            base_mask[i, list(neigh)] = True
    for t in range(T):
        W = Ws[t]
        if not np.allclose(W, W.T, atol=atol):
            raise ValueError(
                f"schedule round {t}: mixing matrix is not symmetric "
                f"(max |W - W^T| = {np.abs(W - W.T).max():.3g}); gossip "
                "under Assumption 1 needs symmetric doubly-stochastic W"
            )
        if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
            raise ValueError(
                f"schedule round {t}: rows do not sum to 1 "
                f"(max |row_sum - 1| = {np.abs(W.sum(axis=1) - 1).max():.3g})"
            )
        if W.min() < -atol:
            raise ValueError(
                f"schedule round {t}: negative weight {W.min():.3g}"
            )
        if base_mask is not None:
            phantom = active_edge_masks(W[None])[0] & ~base_mask
            if phantom.any():
                i, j = np.argwhere(phantom)[0]
                raise ValueError(
                    f"schedule round {t}: edge ({i}, {j}) carries weight "
                    f"{W[i, j]:.3g} but is not in the base topology — the "
                    "network only prices base edges, so it would mix as a "
                    "free zero-latency link"
                )
    return Ws


def active_edge_masks(Ws: np.ndarray) -> np.ndarray:
    """(T, m, m) boolean masks of the edges carrying traffic each round
    (off-diagonal entries above ``ACTIVE_EDGE_EPS``)."""
    Ws = np.asarray(Ws)
    m = Ws.shape[-1]
    return (Ws > ACTIVE_EDGE_EPS) & ~np.eye(m, dtype=bool)


def schedule_version_lags(masks: np.ndarray, versions_per_round: int):
    """Replay the scheduler's lag bookkeeping over a whole schedule:
    returns ``(lags, max_active_lag)`` where ``lags[t]`` is each edge
    pair's reference-version lag AT THE START of round t (an edge inactive
    for r consecutive rounds accumulates ``r * versions_per_round``), and
    ``max_active_lag`` is the largest lag any ACTIVE edge ever re-enters
    with — the extra history depth the delayed mixing operator must carry.
    """
    T, m, _ = masks.shape
    lag = np.zeros((m, m), dtype=np.int64)
    lags = np.zeros((T, m, m), dtype=np.int64)
    max_active = 0
    for t in range(T):
        lags[t] = lag
        act = masks[t]
        if act.any():
            max_active = max(max_active, int(lag[act].max()))
        lag = np.where(act, 0, lag + versions_per_round)
    return lags, max_active


def is_jointly_connected(
    schedule: TopologySchedule, t0: int, window: int
) -> bool:
    """True if the union graph over rounds [t0, t0+window) is connected."""
    m = schedule.base.m
    union = np.zeros((m, m), dtype=bool)
    for t in range(t0, t0 + window):
        union |= active_edge_masks(schedule.weights(t)[None])[0]
    return _connected(union | union.T)
