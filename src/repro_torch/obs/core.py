"""`Obs` — the one observability handle every engine takes as ``obs=``
(``repro.obs.core``'s counterpart).

It bundles what a run needs to be observable:

* a `MetricsSink` the per-round records stream to (`round` / `timing` /
  `heartbeat` emit helpers build the shared `repro_torch.obs.records`
  schema);
* a `HostSpans` recorder (``span(...)`` context manager) so host-side
  costs land on the merged Perfetto timeline (`save_timeline`) next to the
  fabric's simulated lanes;
* the heartbeat knob: ``heartbeat_every=N`` makes a run emit a liveness
  record every N rounds while it runs.  The port's rounds are a Python
  loop, so `scan_heartbeat` is a direct call after each round; it reads
  the round's scalars to the host only on the rounds it samples.

``as_obs`` normalizes the kwarg: None passes through (engines skip all
obs work), a bare sink is wrapped in a default `Obs`, an `Obs` is used
as-is.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Any

from repro_torch.obs.records import (
    heartbeat_record,
    node_record,
    round_record,
    timing_record,
)
from repro_torch.obs.timeline import HostSpans, layer, save_merged_trace


#: one serial number a handle, never reused in the process (`Obs.heartbeat_cache_key`)
_SERIALS = itertools.count()


class Obs:
    """One run's observability handle (see module docstring).

    ``sink`` is any `repro_torch.obs.sink.MetricsSink` (or None: spans still
    record, nothing streams).  ``run`` labels every emitted record so a
    single JSONL file can hold several runs.  ``heartbeat_every`` > 0
    turns on the mid-run heartbeat."""

    def __init__(self, sink=None, heartbeat_every: int = 0, run: str = "run") -> None:
        if heartbeat_every < 0:
            raise ValueError("heartbeat_every must be >= 0")
        self.sink = sink
        self.heartbeat_every = int(heartbeat_every)
        self.run = str(run)
        self.hostspans = HostSpans()
        self.serial = next(_SERIALS)

    # -- emission -----------------------------------------------------------
    def emit(self, record: dict) -> None:
        if self.sink is not None:
            self.sink.emit(record)

    def round(self, engine: str, round_idx: int, row: dict, **kw: Any) -> None:
        self.emit(round_record(engine, self.run, round_idx, row, **kw))

    def node(self, engine: str, round_idx: int, node: int, row: dict, **kw: Any) -> None:
        """One node's view of the round (schema-v2 ``kind="node"`` row),
        emitted alongside — never instead of — the fleet round record."""
        self.emit(node_record(engine, self.run, round_idx, node, row, **kw))

    def heartbeat(self, engine: str, round_idx: int, fields: dict) -> None:
        self.emit(heartbeat_record(engine, self.run, round_idx, fields))

    def timing(self, label: str, seconds: float, engine: str | None = None, **extra: Any) -> None:
        self.emit(timing_record(self.run, label, seconds, engine=engine, **extra))

    # -- host spans ---------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, engine: str | None = None):
        """Record a host wall-clock span AND emit it as a timing record;
        under a profiler it is also a `layer` span on the profiler's clock."""
        t0 = self.hostspans.now()
        try:
            with layer(name):
                yield
        finally:
            sp = self.hostspans.add(name, t0, self.hostspans.now())
            self.timing(name, sp.seconds, engine=engine)

    def save_timeline(self, path: str, trace=None, **kw: Any) -> list[dict]:
        """The merged Perfetto export: this handle's host spans next to a
        fabric's `NetTrace` simulated lanes (pass ``trace=fabric.trace``)."""
        return save_merged_trace(path, trace, self.hostspans, **kw)

    @property
    def heartbeat_on(self) -> bool:
        return self.sink is not None and self.heartbeat_every > 0

    def heartbeat_cache_key(self) -> tuple:
        """The cache-key component of a compiled run's round bodies built
        with this handle, as the reference keys its scans: a body cached
        for one heartbeat handle is never reused with another (or with
        heartbeats off).  The handle is named by its serial number, never
        by ``id(self)``: a cached body does not hold the handle, so once it
        is freed a new one could take its address and its entry."""
        return ("hb", self.heartbeat_every, self.serial) if self.heartbeat_on else ("hb", 0)

    def close(self) -> None:
        close = getattr(self.sink, "close", None)
        if close is not None:
            close()


def as_obs(obs) -> Obs | None:
    """Normalize the engines' ``obs=`` kwarg: None -> None (no obs work),
    `Obs` -> itself, a bare sink -> a default `Obs` around it."""
    if obs is None or isinstance(obs, Obs):
        return obs
    if hasattr(obs, "emit"):
        return Obs(sink=obs)
    raise TypeError(
        f"obs= wants an Obs, a MetricsSink (anything with .emit), or "
        f"None; got {type(obs).__name__}"
    )


def scan_heartbeat(obs: Obs | None, engine: str, round_idx: int, fields: dict) -> None:
    """Emit a heartbeat every ``obs.heartbeat_every`` rounds, called once
    after each round of a run (``round_idx`` is the round's index before
    its update, as in the reference).  ``fields`` maps record keys to the
    round's scalars (tensors on any device); they are read to the host
    only on the sampled rounds."""
    if obs is None or not obs.heartbeat_on or int(round_idx) % obs.heartbeat_every:
        return
    obs.heartbeat(engine, int(round_idx), fields)
