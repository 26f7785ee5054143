"""repro_torch.transport — the gossip transport seam (``repro.transport``'s
counterpart, its pricing half).

One protocol (`Transport`: the `NetworkFabric` pricing API + a
message-exchange primitive) and its simulated backend `SimTransport`, which
the async scheduler reads every arrival through.  The executing backend and
``run(transport=)`` come with a later slice of the port.
"""

from repro_torch.transport.base import ExchangeReport, Transport, as_transport
from repro_torch.transport.sim import SimTransport

__all__ = ["ExchangeReport", "SimTransport", "Transport", "as_transport"]
