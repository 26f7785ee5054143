"""``python -m repro_torch.obs.watch`` — a live terminal dashboard for a run
that is STILL GOING (``repro.obs.watch``'s counterpart).

Attach it to the telemetry stream either way the sinks can produce one:

* ``watch --listen 127.0.0.1:9633`` (or a Unix-socket path) LISTENS for
  a run whose `Obs` carries a ``SocketSink("127.0.0.1:9633")`` — the
  dashboard is the server so it can be up before the run starts, and a
  dead dashboard never hurts the run (the sink drops and counts);
* ``watch run.jsonl`` tails a growing `JsonlSink` file through
  `follow_jsonl` — crash-safe against partially-written trailing lines.

The screen redraws every ``--interval`` seconds with, per engine:
consensus / hypergradient error, cumulative wire bytes split by stream,
the accumulated staleness histogram, heartbeat liveness (how long since
the scan last phoned home), a schema-v2 per-NODE table of consensus
distance, cumulative egress and staleness, and — schema v3 — the
compute meter: cumulative FLOPs, per-kind oracle calls, compile seconds
and memory high-water.  ``--once`` renders
a single frame from whatever is already readable and exits (scripts,
tests); ``--duration`` bounds the session (demos).

Everything stateful lives in `WatchState` (``ingest`` one record at a
time) and `render` is a pure state -> string function, so the display
logic is unit-testable without a terminal.
"""

from __future__ import annotations

import argparse
import socket as socketlib
import sys
import time
from typing import Callable, Iterator

from repro_torch.obs.sink import follow_jsonl, json_safe, parse_address

_ERR_FIELDS = ("hypergrad_norm", "x_consensus_err", "y_consensus_err")
_BARS = " ▁▂▃▄▅▆▇█"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def _sparkline(counts) -> str:
    if not counts:
        return ""
    top = max(counts) or 1
    return "".join(
        _BARS[min(len(_BARS) - 1, round(c / top * (len(_BARS) - 1)))]
        for c in counts
    )


class _EngineView:
    """Accumulated view of one engine's stream."""

    def __init__(self) -> None:
        self.last_round: dict | None = None
        self.rounds = 0
        self.wire_total = 0
        self.streams: dict[str, int] = {}
        self.hist: list[int] = []
        self.heartbeat: dict | None = None
        self.heartbeat_at: float | None = None  # watcher clock
        self.nodes: dict[int, dict] = {}        # latest node row per node
        self.node_wire: dict[int, int] = {}     # cumulative egress
        self.flops_total = 0.0                  # cumulative compute_flops
        self.oracles: dict[str, int] = {}       # cumulative oracle calls
        self.compile_s = 0.0                    # summed compile spans
        self.mem_peak: int | None = None        # allocator high-water


class WatchState:
    """Ingest records one at a time; `render` turns the current state
    into the dashboard frame.  ``clock`` is injectable for tests."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self.engines: dict[str, _EngineView] = {}
        self.records = 0
        self.last_at: float | None = None
        self.run: str | None = None
        self.gates: list[dict] = []

    def _view(self, record: dict) -> _EngineView:
        eng = record.get("engine") or "?"
        return self.engines.setdefault(eng, _EngineView())

    def ingest(self, record: dict) -> None:
        record = json_safe(record)
        self.records += 1
        self.last_at = self.clock()
        if record.get("run"):
            self.run = record["run"]
        kind = record.get("kind")
        if kind == "round":
            v = self._view(record)
            v.last_round = record
            v.rounds += 1
            if record.get("wire_bytes") is not None:
                v.wire_total += int(record["wire_bytes"])
            for k, b in (record.get("bytes_by_stream") or {}).items():
                v.streams[k] = v.streams.get(k, 0) + int(b)
            hist = record.get("staleness_hist")
            if hist:
                if len(hist) > len(v.hist):
                    v.hist += [0] * (len(hist) - len(v.hist))
                for i, c in enumerate(hist):
                    v.hist[i] += int(c)
            # schema-v3 compute meter (absent on older streams)
            if record.get("compute_flops") is not None:
                v.flops_total += float(record["compute_flops"])
            for k, n in (record.get("oracle_calls") or {}).items():
                v.oracles[k] = v.oracles.get(k, 0) + int(n)
            if record.get("compile_seconds") is not None:
                v.compile_s += float(record["compile_seconds"])
            if record.get("memory_peak_bytes") is not None:
                v.mem_peak = max(
                    v.mem_peak or 0, int(record["memory_peak_bytes"])
                )
        elif kind == "node":
            v = self._view(record)
            i = int(record.get("node", -1))
            v.nodes[i] = record
            if record.get("wire_bytes") is not None:
                v.node_wire[i] = (
                    v.node_wire.get(i, 0) + int(record["wire_bytes"])
                )
        elif kind == "heartbeat":
            v = self._view(record)
            v.heartbeat = record
            v.heartbeat_at = self.clock()
        elif kind == "gate":
            self.gates.append(record)

    # -- rendering ------------------------------------------------------
    def render(self, source: str = "") -> str:
        now = self.clock()
        head = f"repro_torch.obs.watch — {source or '(stream)'}"
        if self.run:
            head += f"  run={self.run}"
        if self.last_at is not None:
            head += f"  last record {now - self.last_at:.1f}s ago"
        out = [head, f"records: {self.records}"]
        if not self.engines:
            out.append("(waiting for records...)")
            return "\n".join(out)
        for eng in sorted(self.engines):
            v = self.engines[eng]
            line = f"engine {eng}"
            if v.last_round is not None:
                line += f"  round {v.last_round.get('round')}"
            if v.heartbeat is not None:
                age = now - (v.heartbeat_at or now)
                line += (
                    f"  heartbeat r{v.heartbeat.get('round')}"
                    f" ({age:.1f}s ago"
                    f"{', STALE' if age > 10.0 else ''})"
                )
            out.append(line)
            if v.last_round is not None:
                out.append(
                    "  "
                    + "  ".join(
                        f"{f}={_fmt(v.last_round.get(f))}"
                        for f in _ERR_FIELDS
                    )
                )
            elif v.heartbeat is not None:
                hb_fields = {
                    k: b for k, b in v.heartbeat.items()
                    if k in _ERR_FIELDS
                }
                if hb_fields:
                    out.append(
                        "  "
                        + "  ".join(
                            f"{k}={_fmt(b)}" for k, b in hb_fields.items()
                        )
                    )
            if v.wire_total or v.streams:
                line = f"  wire {_fmt_bytes(v.wire_total)} total"
                if v.streams:
                    line += "   " + "  ".join(
                        f"{k}={_fmt_bytes(b)}"
                        for k, b in sorted(v.streams.items())
                    )
                out.append(line)
            if v.hist and sum(v.hist):
                smax = max(i for i, c in enumerate(v.hist) if c)
                out.append(
                    f"  staleness hist {_sparkline(v.hist)} (max age {smax})"
                )
            if v.flops_total or v.oracles:
                line = f"  compute {_fmt(v.flops_total)} flops"
                if v.oracles:
                    line += "   " + "  ".join(
                        f"{k}={n}" for k, n in sorted(v.oracles.items())
                    )
                if v.compile_s:
                    line += f"   compile={v.compile_s:.2f}s"
                if v.mem_peak is not None:
                    line += f"   mem_peak={_fmt_bytes(v.mem_peak)}"
                out.append(line)
            if v.nodes:
                out.append(
                    "  node   x_dist      wire_cum    stale(max/mean)"
                )
                for i in sorted(v.nodes):
                    r = v.nodes[i]
                    stale = (
                        f"{_fmt(r.get('staleness_max'))}/"
                        f"{_fmt(r.get('staleness_mean'))}"
                    )
                    out.append(
                        f"  {i:<6} {_fmt(r.get('x_dist')):<11} "
                        f"{_fmt_bytes(v.node_wire.get(i)):<11} {stale}"
                    )
        for g in self.gates[-4:]:
            out.append(
                f"gate {g.get('policy')}: wire={g.get('wire_bytes')} "
                f"warm_wall={_fmt(g.get('warm_wall_s'))}s"
            )
        return "\n".join(out)


def listen_records(
    address: str,
    *,
    stop: Callable[[], bool] | None = None,
    timeout_s: float | None = None,
    poll_s: float = 0.2,
) -> Iterator[dict]:
    """Listen on ``address`` (``host:port`` TCP or a Unix-socket path)
    and yield each line-delimited JSON record the connecting `SocketSink`
    writers send.  CONCURRENT writers are multiplexed (``select`` over
    the accepted connections, one carry buffer per connection), so
    several simultaneous runs can feed one dashboard — records interleave
    at line granularity, each line staying intact.  A writer
    disconnecting just drops its connection; the listener keeps serving
    the others and keeps accepting.  Ends on ``stop()`` / ``timeout_s``."""
    import json as jsonlib
    import os
    import select

    family, addr = parse_address(address)
    if family == socketlib.AF_UNIX and os.path.exists(addr):
        os.unlink(addr)  # stale socket file from a previous session
    deadline = None if timeout_s is None else time.monotonic() + timeout_s

    def expired() -> bool:
        if stop is not None and stop():
            return True
        return deadline is not None and time.monotonic() >= deadline

    srv = socketlib.socket(family, socketlib.SOCK_STREAM)
    conns: dict[socketlib.socket, bytes] = {}  # connection -> carry buffer
    try:
        if family == socketlib.AF_INET:
            srv.setsockopt(
                socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1
            )
        srv.bind(addr)
        srv.listen(16)
        srv.setblocking(False)
        while not expired():
            readable, _, _ = select.select(
                [srv, *conns], [], [], poll_s
            )
            for sock in readable:
                if sock is srv:
                    try:
                        conn, _ = srv.accept()
                    except OSError:
                        continue
                    conn.setblocking(False)
                    conns[conn] = b""
                    continue
                try:
                    chunk = sock.recv(1 << 16)
                except BlockingIOError:
                    continue
                except OSError:
                    chunk = b""
                if not chunk:  # writer closed or died; drop just this one
                    sock.close()
                    conns.pop(sock, None)
                    continue
                carry = conns[sock] + chunk
                *lines, conns[sock] = carry.split(b"\n")
                for raw in lines:
                    raw = raw.strip()
                    if raw:
                        yield jsonlib.loads(raw)
    finally:
        for sock in conns:
            sock.close()
        srv.close()
        if family == socketlib.AF_UNIX and os.path.exists(addr):
            os.unlink(addr)


def watch(
    records: Iterator[dict],
    *,
    source: str = "",
    interval_s: float = 0.5,
    once: bool = False,
    out=None,
    clock: Callable[[], float] = time.monotonic,
) -> WatchState:
    """Drive a `WatchState` from a record iterator, redrawing at most
    every ``interval_s``.  ``once`` renders a single frame after the
    iterator is exhausted (pair with a bounded iterator).  Returns the
    final state (tests read it directly)."""
    out = out if out is not None else sys.stdout
    state = WatchState(clock=clock)
    last_draw = None
    interactive = not once and getattr(out, "isatty", lambda: False)()

    def draw() -> None:
        frame = state.render(source)
        if interactive:
            out.write("\x1b[2J\x1b[H" + frame + "\n")
        else:
            out.write(frame + "\n")
        out.flush()

    for rec in records:
        state.ingest(rec)
        if once:
            continue
        now = clock()
        if last_draw is None or now - last_draw >= interval_s:
            draw()
            last_draw = now
    draw()
    return state


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.watch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "jsonl", nargs="?",
        help="JSONL file written by a JsonlSink to tail (omit with "
        "--listen)",
    )
    p.add_argument(
        "--listen", metavar="ADDR",
        help="listen for a SocketSink on host:port (TCP) or a "
        "filesystem path (Unix socket) instead of tailing a file",
    )
    p.add_argument(
        "--interval", type=float, default=0.5,
        help="minimum seconds between redraws (default 0.5)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="render one frame from what is already readable, then exit",
    )
    p.add_argument(
        "--duration", type=float, default=None,
        help="stop after this many seconds (default: follow forever)",
    )
    args = p.parse_args(argv)
    if (args.jsonl is None) == (args.listen is None):
        p.error("pass exactly one of a JSONL path or --listen ADDR")

    if args.listen:
        source = args.listen
        timeout = 0.0 if args.once else args.duration
        records = listen_records(args.listen, timeout_s=timeout)
    else:
        source = args.jsonl
        timeout = 0.0 if args.once else args.duration
        records = follow_jsonl(args.jsonl, timeout_s=timeout)
    try:
        watch(
            records, source=source, interval_s=args.interval,
            once=args.once,
        )
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
