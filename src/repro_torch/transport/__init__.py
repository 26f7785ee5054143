"""repro_torch.transport — pluggable gossip transport backends
(``repro.transport``'s counterpart).

One protocol (`Transport`: the `NetworkFabric` pricing API + an executed
message-exchange primitive), two backends:

* `SimTransport`    — the priced simulation, bit for bit the same as
  passing its fabric to ``c2dfb.run`` directly;
* `DeviceTransport` — in-process execution over a `NodeMesh` of m ranks on
  the run's device: gossip as neighbour shifts or a gather carrying the
  actual wire payloads (packed on the device by the pack kernel and
  unpacked by the unpack kernel when ``fused``), metered by the codec.

``c2dfb.run(transport=...)`` (`run_c2dfb_transport`) runs the same
algorithm on either.
"""

from repro_torch.transport.base import ExchangeReport, Transport, as_transport
from repro_torch.transport.device import DeviceTransport, NodeMesh, make_device_round, mesh_for_nodes
from repro_torch.transport.engine import run_c2dfb_transport
from repro_torch.transport.sim import SimTransport

__all__ = [
    "DeviceTransport",
    "ExchangeReport",
    "NodeMesh",
    "SimTransport",
    "Transport",
    "as_transport",
    "make_device_round",
    "mesh_for_nodes",
    "run_c2dfb_transport",
]
