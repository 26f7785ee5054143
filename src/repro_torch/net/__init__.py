"""repro_torch.net — the network fabric subsystem (``repro.net``'s
counterpart).

* ``wire``    — exact serialization codecs per compressor (integer bytes,
  bit-exact round trips), backed by the pack/unpack kernel.
* ``fabric``  — deterministic event-driven link simulation (latency,
  bandwidth, jitter, egress serialization, stragglers) turning per-round
  payloads into wall-clock timelines.
* ``dynamic`` — time-varying topology schedules (dropout, random edges,
  B-connected sequences) that plug into gossip as per-round W matrices.
* ``trace``   — JSON / Chrome-trace export of simulated timelines.
"""

from repro_torch.net.dynamic import (
    BConnectedSchedule,
    LatencyDropoutSchedule,
    LinkDropoutSchedule,
    RandomEdgeSchedule,
    StaticSchedule,
    TopologySchedule,
    active_edge_masks,
    is_jointly_connected,
    schedule_version_lags,
    validate_schedule_stack,
)
from repro_torch.net.fabric import (
    PROFILES,
    LinkModel,
    NetworkFabric,
    StragglerModel,
    edge_list,
    make_fabric,
)
from repro_torch.net.trace import NetTrace, PhaseEvent, StepEvent, TransferEvent
from repro_torch.net.wire import (
    BlockSparseCodec,
    DenseCodec,
    QuantCodec,
    SparseCodec,
    WireCodec,
    codec_for,
    measure_compressed_tree_bytes,
    measure_tree_bytes,
    measure_tree_bytes_chunked,
    scan_tree_bytes,
)

__all__ = [
    "BConnectedSchedule",
    "BlockSparseCodec",
    "DenseCodec",
    "LatencyDropoutSchedule",
    "LinkDropoutSchedule",
    "LinkModel",
    "NetTrace",
    "NetworkFabric",
    "PROFILES",
    "PhaseEvent",
    "QuantCodec",
    "RandomEdgeSchedule",
    "SparseCodec",
    "StaticSchedule",
    "StepEvent",
    "StragglerModel",
    "TopologySchedule",
    "TransferEvent",
    "WireCodec",
    "active_edge_masks",
    "codec_for",
    "edge_list",
    "is_jointly_connected",
    "make_fabric",
    "measure_compressed_tree_bytes",
    "measure_tree_bytes",
    "measure_tree_bytes_chunked",
    "scan_tree_bytes",
    "schedule_version_lags",
    "validate_schedule_stack",
]
