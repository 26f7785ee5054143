"""Deterministic event-driven network fabric for decentralized gossip
(``repro.net.fabric``'s counterpart; host numpy, so the same seed gives the
reference's timeline float for float).

The SPMD simulator moves dense tensors instantly; this module converts each
round's per-edge payload bytes into a simulated wall-clock timeline under a
per-link latency/bandwidth model with optional jitter, per-node compute
stragglers, and NIC egress serialization (a node's messages share its
uplink and leave one after another, neighbor order).

A synchronous gossip *phase* (one message per directed edge, then a
barrier) completes when every node has received all its in-edges:

    depart(i -> j, n-th msg)  = ready_i + sum_{<n} bytes/bw      (egress)
    arrive(i -> j)            = depart + bytes/bw + latency + jitter
    phase end                 = max over nodes of max(in-arrivals, ready)

``ready_i`` is the node's compute-finish time for the phase, scaled by its
straggler multiplier.  Everything is driven by ``np.random.default_rng``
seeded per (fabric seed, round), so a fixed seed reproduces the timeline
event-for-event regardless of call order (tested).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.net.trace import NetTrace, PhaseEvent, TransferEvent


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One directed link: fixed propagation delay + shared bandwidth."""

    latency_s: float
    bandwidth_Bps: float
    jitter_s: float = 0.0  # uniform [0, jitter_s) extra delay per message

    def transfer_s(self, nbytes: int) -> float:
        return nbytes / self.bandwidth_Bps


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Per-round per-node compute-time multipliers.

    kind:
      * "none"       — all 1.0
      * "lognormal"  — exp(N(0, sigma)); heavy-tailed slow nodes
      * "bernoulli"  — with prob p a node is `slowdown`x slower this round
    """

    kind: str = "none"
    sigma: float = 0.5
    p: float = 0.1
    slowdown: float = 5.0

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        if self.kind == "none":
            return np.ones(m)
        if self.kind == "lognormal":
            return np.exp(rng.normal(0.0, self.sigma, size=m))
        if self.kind == "bernoulli":
            slow = rng.random(m) < self.p
            return np.where(slow, self.slowdown, 1.0)
        raise ValueError(f"unknown straggler kind {self.kind!r}")


#: Canonical deployment profiles (per directed link).
PROFILES: dict[str, LinkModel] = {
    # datacenter 10 GbE, sub-ms RTT
    "lan": LinkModel(latency_s=50e-6, bandwidth_Bps=1.25e9),
    # cross-region 100 Mbit/s, 30 ms one-way
    "wan": LinkModel(latency_s=30e-3, bandwidth_Bps=12.5e6, jitter_s=2e-3),
    # intercontinental 20 Mbit/s, 120 ms one-way
    "geo": LinkModel(latency_s=120e-3, bandwidth_Bps=2.5e6, jitter_s=10e-3),
    # ideal instantaneous fabric: every message lands the moment it departs.
    # Under it an asynchronous run can never observe staleness, so the
    # async engine must reproduce the synchronous trajectory.
    "zero": LinkModel(latency_s=0.0, bandwidth_Bps=float("inf")),
}


@dataclasses.dataclass(frozen=True)
class PhaseReport:
    duration_s: float
    node_finish_s: np.ndarray  # (m,) per-node completion offset within phase
    bytes_on_wire: int


def edge_list(topo: Topology) -> tuple[tuple[int, int], ...]:
    """All directed edges (i, j), i != j, of the gossip graph."""
    return tuple(
        (i, j) for i in range(topo.m) for j in topo.neighbors[i]
    )


def edges_from_weights(W) -> tuple[tuple[int, int], ...]:
    """Directed edges actually carrying traffic under a mixing matrix W
    (off-diagonal positive entries) — the per-round edge set of a
    `repro_torch.net.dynamic` schedule step."""
    W = np.asarray(W)
    m = W.shape[0]
    off = (W > 1e-12) & ~np.eye(m, dtype=bool)
    return tuple((i, j) for i in range(m) for j in range(m) if off[i, j])


def mask_phases(phases: list, edges) -> list:
    """Restrict per-edge phase payload dicts to the given edge set."""
    act = set(edges)
    return [
        {e: b for e, b in ph.items() if e in act}
        if isinstance(ph, dict)
        else ph
        for ph in phases
    ]


class NetworkFabric:
    """Simulates gossip rounds on a fixed graph under a link model.

    Parameters
    ----------
    topo          : the gossip graph (directed edges = ordered neighbor pairs)
    link          : LinkModel, or a profile name from ``PROFILES``
    straggler     : optional StragglerModel for per-node compute skew
    compute_s     : baseline per-node compute seconds per *round* (split
                    evenly across the round's phases)
    seed          : all randomness (jitter, stragglers) derives from this
    trace         : optional NetTrace that receives every event
    """

    def __init__(
        self,
        topo: Topology,
        link: LinkModel | str = "lan",
        straggler: StragglerModel | None = None,
        compute_s: float = 0.0,
        seed: int = 0,
        trace: NetTrace | None = None,
    ) -> None:
        self.topo = topo
        self.link = PROFILES[link] if isinstance(link, str) else link
        self.straggler = straggler or StragglerModel()
        self.compute_s = compute_s
        self.seed = seed
        self.trace = trace
        self.clock_s = 0.0
        self._edges = edge_list(topo)

    # ------------------------------------------------------------------
    def round_rng(self, round_idx: int, stream: int = 0) -> np.random.Generator:
        """Deterministic per-(seed, round[, stream]) RNG — the fabric's only
        randomness source.  ``stream`` separates consumers (e.g. the async
        scheduler) from the barrier simulation so neither perturbs the other."""
        if stream:
            return np.random.default_rng((self.seed, round_idx, stream))
        return np.random.default_rng((self.seed, round_idx))

    _round_rng = round_rng

    # -- per-message (non-barrier) queries ------------------------------
    def egress_s(self, nbytes: int) -> float:
        """Seconds a message of ``nbytes`` occupies the sender's NIC uplink."""
        return self.link.transfer_s(nbytes)

    def message_arrival(
        self, depart_s: float, nbytes: int, rng: np.random.Generator
    ) -> float:
        """Absolute arrival time of ONE message put on a link at ``depart_s``.

        This is the non-barrier query the async scheduler is built on: the
        caller owns per-node clocks and NIC egress serialization (via
        ``egress_s``); the fabric prices the flight — transfer + propagation
        + jitter — exactly as ``simulate_phase`` does for barrier phases.
        """
        jitter = rng.random() * self.link.jitter_s if self.link.jitter_s else 0.0
        return depart_s + self.link.transfer_s(nbytes) + self.link.latency_s + jitter

    def simulate_phase(
        self,
        edge_bytes: dict[tuple[int, int], int] | int,
        rng: np.random.Generator,
        node_ready: np.ndarray,
        round_idx: int = 0,
        phase_idx: int = 0,
    ) -> PhaseReport:
        """One barrier-synchronized message exchange.  ``edge_bytes`` maps
        directed edge -> payload bytes (or a single int for all edges);
        ``node_ready`` is each node's compute-finish offset (seconds)."""
        m = self.topo.m
        if isinstance(edge_bytes, (int, np.integer)):
            edge_bytes = {e: int(edge_bytes) for e in self._edges}
        arrive = np.array(node_ready, dtype=float)  # at least own compute
        egress_free = np.array(node_ready, dtype=float)
        total = 0
        # deterministic order: edges sorted by (src, dst)
        for (i, j) in sorted(edge_bytes):
            nbytes = int(edge_bytes[(i, j)])
            total += nbytes
            xfer = self.link.transfer_s(nbytes)
            depart = egress_free[i]
            egress_free[i] = depart + xfer  # NIC serialization
            jitter = (
                rng.random() * self.link.jitter_s if self.link.jitter_s else 0.0
            )
            t_arrive = depart + xfer + self.link.latency_s + jitter
            arrive[j] = max(arrive[j], t_arrive)
            if self.trace is not None:
                self.trace.add_transfer(
                    TransferEvent(
                        round=round_idx,
                        phase=phase_idx,
                        src=i,
                        dst=j,
                        bytes=nbytes,
                        t_start=self.clock_s + depart,
                        t_end=self.clock_s + t_arrive,
                    )
                )
        return PhaseReport(
            duration_s=float(arrive.max()) if m else 0.0,
            node_finish_s=arrive,
            bytes_on_wire=total,
        )

    def simulate_round(
        self,
        phases: Sequence[dict[tuple[int, int], int] | int],
        round_idx: int,
        labels: Sequence[str] | None = None,
    ) -> dict:
        """Simulate one algorithm round = a sequence of barrier phases.

        Straggler multipliers are drawn once per round per node and applied
        to the compute slice preceding every phase.  Returns a metrics dict
        with ``sim_seconds`` (round duration), ``wire_bytes`` (total), and
        per-phase durations; advances the fabric clock.
        """
        rng = self._round_rng(round_idx)
        mult = self.straggler.sample(rng, self.topo.m)
        compute = (
            mult * (self.compute_s / max(len(phases), 1))
            if self.compute_s
            else np.zeros(self.topo.m)
        )
        t = 0.0
        total = 0
        per_phase = []
        for p, edge_bytes in enumerate(phases):
            rep = self.simulate_phase(
                edge_bytes, rng, compute, round_idx=round_idx, phase_idx=p
            )
            if self.trace is not None:
                label = labels[p] if labels else f"phase{p}"
                self.trace.add_phase(
                    PhaseEvent(
                        round=round_idx,
                        phase=p,
                        label=label,
                        t_start=self.clock_s + t,
                        t_end=self.clock_s + t + rep.duration_s,
                    )
                )
            t += rep.duration_s
            total += rep.bytes_on_wire
            per_phase.append(rep.duration_s)
        self.clock_s += t
        return {
            "sim_seconds": t,
            "wire_bytes": total,
            "phase_seconds": per_phase,
            "straggler_mult": mult,
        }

    def reset(self) -> None:
        self.clock_s = 0.0


def make_fabric(
    topo: Topology,
    profile: str = "lan",
    straggler: str = "none",
    compute_s: float = 0.0,
    seed: int = 0,
    trace: NetTrace | None = None,
    **straggler_kw,
) -> NetworkFabric:
    """Convenience constructor from profile names (see ``PROFILES``)."""
    return NetworkFabric(
        topo,
        link=profile,
        straggler=StragglerModel(kind=straggler, **straggler_kw),
        compute_s=compute_s,
        seed=seed,
        trace=trace,
    )
