"""The `Transport` protocol (``repro.transport.base``'s counterpart): one
phase/exchange interface over the network fabric.

`repro_torch.net.fabric.NetworkFabric` *prices* gossip phases (it turns
per-edge payload bytes into a simulated wall-clock timeline) but nothing
moves: the node-stacked tensors are the "network".  A `Transport` exposes
both faces of a backend:

* the **pricing face** — `simulate_phase` / `simulate_round` /
  `message_arrival` / `egress_s` / `round_rng`, byte for byte the
  `NetworkFabric` API (every transport owns a fabric and delegates, so the
  async scheduler and the round metrics consume one interface regardless
  of backend);
* the **exchange face** — `exchange(payload, compressor, ...)`, one-phase
  message delivery: every node broadcasts its node-stacked payload slice
  to its neighbors and the transport returns the tree as received.
  `SimTransport` delivers by identity and only prices;
  `DeviceTransport` (`repro_torch.transport.device`) serializes each slice
  with the wire codec (`repro_torch.net.wire`), delivers it to the ranks
  of its mesh and returns the decoded receipt, so compression error and
  byte counts come from executed code.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np

from repro_torch.core.compression import Compressor, make_compressor
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, tree_map
from repro_torch.net.fabric import NetworkFabric, edge_list
from repro_torch.net.wire import codec_for

#: RNG stream for standalone `exchange` pricing — separated from the
#: fabric's barrier simulation (stream 0) and the async scheduler (0xA5)
#: so transports never perturb either timeline.
EXCHANGE_STREAM = 0x7A


@dataclasses.dataclass(frozen=True)
class ExchangeReport:
    """What one executed/priced exchange put on the wire.

    node_bytes   per-sender serialized bytes of ONE message (codec truth —
                 equals `wire.measure_tree_bytes` on that node's slice)
    wire_bytes   per-link total: each directed edge carries its sender's
                 message once (sum of node_bytes weighted by out-degree)
    duration_s   simulated phase duration under the transport's link model
    wall_s       host wall-clock spent executing (0.0 for pure simulation)
    label        phase label (for traces)
    """

    node_bytes: tuple
    wire_bytes: int
    duration_s: float
    wall_s: float
    label: str


class Transport(abc.ABC):
    """Abstract gossip transport: `NetworkFabric`'s pricing API plus an
    executed message-exchange primitive.  Concrete backends:

    * `repro_torch.transport.sim.SimTransport` — the priced simulation
      (bit-exact with passing the wrapped fabric directly)
    * `repro_torch.transport.device.DeviceTransport` — in-process
      execution between the ranks of a node mesh

    A transport must be bound to a topology (`bind`) before use; binding
    constructs/validates the internal pricing fabric.
    """

    fabric: NetworkFabric | None = None

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    @abc.abstractmethod
    def bind(self, topo: Topology) -> "Transport":
        """Attach the gossip graph; idempotent for the same topology,
        raises ValueError if already bound to a different one."""

    def _require_bound(self) -> NetworkFabric:
        if self.fabric is None:
            raise ValueError(
                f"{type(self).__name__} is not bound to a topology yet — "
                "call transport.bind(topo) (c2dfb.run does this for you)"
            )
        return self.fabric

    # ------------------------------------------------------------------
    # pricing face: the NetworkFabric API, by delegation
    # ------------------------------------------------------------------
    @property
    def topo(self) -> Topology:
        return self._require_bound().topo

    @property
    def link(self):
        return self._require_bound().link

    @property
    def straggler(self):
        return self._require_bound().straggler

    @property
    def compute_s(self) -> float:
        return self._require_bound().compute_s

    @property
    def seed(self) -> int:
        return self._require_bound().seed

    @property
    def trace(self):
        return self._require_bound().trace

    @property
    def clock_s(self) -> float:
        return self._require_bound().clock_s

    def round_rng(self, round_idx: int, stream: int = 0):
        return self._require_bound().round_rng(round_idx, stream)

    def egress_s(self, nbytes: int) -> float:
        return self._require_bound().egress_s(nbytes)

    def message_arrival(self, depart_s, nbytes, rng) -> float:
        return self._require_bound().message_arrival(depart_s, nbytes, rng)

    def simulate_phase(self, edge_bytes, rng, node_ready, round_idx=0,
                       phase_idx=0):
        return self._require_bound().simulate_phase(
            edge_bytes, rng, node_ready, round_idx, phase_idx
        )

    def simulate_round(self, phases, round_idx, labels=None) -> dict:
        return self._require_bound().simulate_round(phases, round_idx, labels)

    def reset(self) -> None:
        self._require_bound().reset()

    # ------------------------------------------------------------------
    # exchange face
    # ------------------------------------------------------------------
    @property
    @abc.abstractmethod
    def executes(self) -> bool:
        """True when `exchange` physically moves payloads (device/multi-
        process backends); False for pure priced simulation."""

    @abc.abstractmethod
    def exchange(
        self,
        payload: Tree,
        compressor: Compressor | None = None,
        round_idx: int = 0,
        phase_idx: int = 0,
        label: str = "exchange",
        edges=None,
    ) -> tuple[Tree, ExchangeReport]:
        """One gossip phase: every node broadcasts its slice of the
        node-stacked ``payload`` tree (leading axis m) to its neighbors.

        Returns ``(delivered, report)`` where ``delivered`` is the
        node-stacked tree as RECEIVED (identical to ``payload`` for the
        simulator; the codec round-trip of it for an executing backend —
        bit-exact for every codec except KernelQuant's 1-ulp dequant) and
        ``report`` carries the exact executed/priced byte counts.
        ``compressor`` selects the wire codec (None = dense f32);
        ``edges`` restricts the phase to a subset of directed edges (a
        dynamic-schedule round's active set)."""

    # ------------------------------------------------------------------
    # shared helpers for concrete backends
    # ------------------------------------------------------------------
    def _edge_set(self, edges) -> tuple:
        return tuple(edges) if edges is not None else edge_list(self.topo)

    def _measure_payload(
        self, payload: Tree, compressor: Compressor | None, edges
    ) -> tuple[tuple, int, dict]:
        """Codec-measure a node-stacked payload: per-node single-message
        bytes, per-link total over ``edges``, and the per-edge byte dict
        `simulate_phase` consumes."""
        comp = compressor if compressor is not None else make_compressor(
            "identity"
        )
        codec = codec_for(comp)
        m = self.topo.m
        node_bytes = tuple(
            codec.tree_bytes(tree_map(lambda v, i=i: v[i], payload))
            for i in range(m)
        )
        edge_bytes = {(i, j): node_bytes[i] for (i, j) in edges}
        return node_bytes, int(sum(edge_bytes.values())), edge_bytes

    def _price_phase(
        self, edge_bytes: dict, round_idx: int, phase_idx: int
    ) -> float:
        """Price one standalone exchange on the fabric's link model using
        the dedicated EXCHANGE_STREAM rng (does not advance the fabric
        clock or perturb its barrier/scheduler streams)."""
        fabric = self._require_bound()
        rng = fabric.round_rng(round_idx, stream=EXCHANGE_STREAM)
        rep = fabric.simulate_phase(
            edge_bytes, rng, np.zeros(self.topo.m), round_idx, phase_idx
        )
        return float(rep.duration_s)


def as_transport(fabric_or_transport) -> Transport:
    """Normalize a `NetworkFabric` (or None) to a `Transport`: fabrics are
    wrapped in a `SimTransport` (bit-exact delegation), transports pass
    through."""
    if fabric_or_transport is None or isinstance(fabric_or_transport, Transport):
        return fabric_or_transport
    from repro_torch.transport.sim import SimTransport

    return SimTransport(fabric_or_transport)
