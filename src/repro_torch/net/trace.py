"""Per-round network event logs, exportable as JSON timelines
(``repro.net.trace``'s counterpart, pure Python).

A ``NetTrace`` accumulates ``TransferEvent``s (one per message put on a
link) and ``PhaseEvent``s (one per barrier-synchronized communication
phase).  ``to_json`` emits a plain dict structure; ``to_chrome_trace``
emits the Chrome ``chrome://tracing`` / Perfetto event format so a
simulated round can be inspected visually (one lane per node).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class TransferEvent:
    round: int
    phase: int
    src: int
    dst: int
    bytes: int
    t_start: float   # seconds since simulation start
    t_end: float


@dataclasses.dataclass(frozen=True)
class PhaseEvent:
    round: int
    phase: int
    label: str
    t_start: float
    t_end: float


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One node's local compute slice in an ASYNC (non-barrier) execution:
    node ``node`` ran step ``step`` of loop ``loop`` ("y", "z", "outer")
    between its own gate time and its compute finish.  Emitted by the
    asynchronous scheduler (`repro_torch.async_gossip.scheduler`); in the Chrome
    export each node gets its own lane, so staleness shows up visually as
    lanes drifting apart."""

    round: int
    loop: str
    step: int
    node: int
    t_start: float
    t_end: float


class NetTrace:
    """Append-only event log for one fabric simulation."""

    def __init__(self) -> None:
        self.transfers: list[TransferEvent] = []
        self.phases: list[PhaseEvent] = []
        self.steps: list[StepEvent] = []

    def add_transfer(self, ev: TransferEvent) -> None:
        self.transfers.append(ev)

    def add_phase(self, ev: PhaseEvent) -> None:
        self.phases.append(ev)

    def add_step(self, ev: StepEvent) -> None:
        self.steps.append(ev)

    # -- exports ------------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        return {
            "transfers": [dataclasses.asdict(e) for e in self.transfers],
            "phases": [dataclasses.asdict(e) for e in self.phases],
            "steps": [dataclasses.asdict(e) for e in self.steps],
        }

    def to_chrome_trace(self) -> list[dict[str, Any]]:
        """Chrome trace-event format: X events, one pid per node lane."""
        out = []
        for e in self.transfers:
            out.append(
                {
                    "name": f"r{e.round}p{e.phase} {e.src}->{e.dst} "
                    f"{e.bytes}B",
                    "ph": "X",
                    "pid": e.src,
                    "tid": e.dst,
                    "ts": e.t_start * 1e6,   # chrome wants microseconds
                    "dur": (e.t_end - e.t_start) * 1e6,
                }
            )
        for e in self.phases:
            out.append(
                {
                    "name": f"r{e.round} {e.label}",
                    "ph": "X",
                    "pid": "phases",
                    "tid": e.phase,
                    "ts": e.t_start * 1e6,
                    "dur": (e.t_end - e.t_start) * 1e6,
                }
            )
        for e in self.steps:
            out.append(
                {
                    "name": f"r{e.round} {e.loop}{e.step}",
                    "ph": "X",
                    "pid": f"node{e.node}",
                    "tid": e.loop,
                    "ts": e.t_start * 1e6,
                    "dur": (e.t_end - e.t_start) * 1e6,
                }
            )
        return out

    def save(self, path: str, chrome: bool = False) -> None:
        payload = self.to_chrome_trace() if chrome else self.to_json()
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1)
