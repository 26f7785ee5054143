"""`SimTransport` (``repro.transport.sim``'s counterpart) — the
priced-simulation backend of the transport seam.

A thin adapter over a `repro_torch.net.fabric.NetworkFabric`: the pricing
face delegates verbatim (same RNG streams, same event order), so every
timeline a `SimTransport` produces is BIT-EXACT with calling the fabric
directly.  The exchange face delivers by identity (the node-stacked tensor
IS the network) but still codec-measures the payload and prices the phase,
so protocol-conformance code paths see real byte counts and durations.
"""

from __future__ import annotations

from repro_torch.core.compression import Compressor
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree
from repro_torch.net.fabric import NetworkFabric, make_fabric
from repro_torch.transport.base import ExchangeReport, Transport


class SimTransport(Transport):
    """Wrap a `NetworkFabric` as a `Transport`.

    Either hand it a ready fabric (``SimTransport(fabric)``) or construct
    one lazily from profile kwargs at `bind` time
    (``SimTransport(profile="wan", straggler="lognormal", sigma=0.8)``).
    """

    def __init__(self, fabric: NetworkFabric | None = None, **fabric_kw):
        if fabric is not None and fabric_kw:
            raise ValueError("pass a fabric OR profile kwargs, not both")
        self.fabric = fabric
        self._fabric_kw = fabric_kw

    def bind(self, topo: Topology) -> "SimTransport":
        if self.fabric is None:
            self.fabric = make_fabric(topo, **self._fabric_kw)
        elif self.fabric.topo.name != topo.name or self.fabric.topo.m != topo.m:
            raise ValueError(
                f"SimTransport is bound to topology "
                f"{self.fabric.topo.name!r} (m={self.fabric.topo.m}) but was "
                f"asked to run on {topo.name!r} (m={topo.m})"
            )
        return self

    @property
    def executes(self) -> bool:
        return False

    def exchange(
        self,
        payload: Tree,
        compressor: Compressor | None = None,
        round_idx: int = 0,
        phase_idx: int = 0,
        label: str = "exchange",
        edges=None,
    ) -> tuple[Tree, ExchangeReport]:
        self._require_bound()
        edges = self._edge_set(edges)
        node_bytes, wire_bytes, edge_bytes = self._measure_payload(
            payload, compressor, edges
        )
        duration = self._price_phase(edge_bytes, round_idx, phase_idx)
        return payload, ExchangeReport(
            node_bytes=node_bytes,
            wire_bytes=wire_bytes,
            duration_s=duration,
            wall_s=0.0,
            label=label,
        )
