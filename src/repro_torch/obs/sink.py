"""Metric sinks — where the per-round observability records go
(``repro.obs.sink``'s counterpart).

One protocol (`MetricsSink.emit` takes a plain dict, one call per
record), four shipped implementations:

* `MemorySink`  — append to a list (tests, notebooks, parity asserts);
* `JsonlSink`   — stream one JSON line per record to a file, flushed per
  emit so a crashed / killed run keeps every completed round;
* `SocketSink`  — stream line-delimited JSON to a TCP or Unix-domain
  socket a live dashboard (``python -m repro_torch.obs.watch``) listens on.
  NEVER blocks or fails the run: sends are non-blocking, a slow reader
  buffers up to ``max_buffer`` bytes, and past that (or once the reader
  dies) records are dropped and counted (``.dropped``) — telemetry must
  not become the run's straggler;
* `MultiSink`   — fan one stream out to several sinks.

The read side tolerates a LIVE writer: `read_jsonl` / `iter_jsonl`
return the clean prefix when the final line is a partially-written
record (``.truncated`` flags it), and `follow_jsonl` tails a growing
file, holding a partial trailing line back until its newline lands.

Sinks are intentionally dumb: all schema knowledge lives in
`repro_torch.obs.records`, all engine plumbing in the engines' ``obs=`` kwarg
(`repro_torch.obs.Obs`).  Records may arrive from another thread than the
run's, so the shipped sinks guard their append/write with a lock.
"""

from __future__ import annotations

import json
import os
import socket as socketlib
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class MetricsSink(Protocol):
    """Anything with ``emit(record: dict)``; ``close()`` is optional and
    called (when present) by `Obs.close` / the sink context managers."""

    def emit(self, record: dict) -> None: ...


def json_safe(obj: Any) -> Any:
    """Recursively coerce a record to plain JSON types: numpy scalars /
    arrays and torch tensors (0-d or not, on any device) become Python
    numbers / lists, non-finite floats become None (bare NaN tokens are not
    RFC-8259 JSON and break jq / JSON.parse)."""
    if hasattr(obj, "detach"):  # a torch tensor (numpy has no bf16)
        obj = obj.detach().cpu()
        obj = (obj.float() if obj.is_floating_point() and obj.element_size() < 4 else obj).numpy()
        if obj.ndim == 0:
            obj = obj[()]
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [json_safe(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        obj = float(obj)
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


class MemorySink:
    """Collect records in memory (``.records``)."""

    def __init__(self) -> None:
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        with self._lock:
            self.records.append(json_safe(record))

    def rows(self, kind: str | None = None, run: str | None = None) -> list[dict]:
        """Records filtered by ``kind`` / ``run`` label (None = all)."""
        return [
            r for r in self.records
            if (kind is None or r.get("kind") == kind)
            and (run is None or r.get("run") == run)
        ]

    def close(self) -> None:  # protocol symmetry; nothing to release
        pass


class JsonlSink:
    """Stream records to ``path``, one JSON object per line, flushed per
    emit — a crashed run keeps every record emitted before the crash."""

    def __init__(self, path: str, append: bool = False) -> None:
        self.path = str(path)
        self._fh = open(self.path, "a" if append else "w")
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        line = json.dumps(json_safe(record), sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def parse_address(address: str | tuple) -> tuple:
    """Normalize a sink/watch address: ``(host, port)`` or ``"host:port"``
    (port all digits) is TCP, anything else is a Unix-socket path.
    Returns ``(family, address)`` ready for `socket.socket` / connect."""
    if isinstance(address, tuple):
        host, port = address
        return socketlib.AF_INET, (str(host), int(port))
    address = str(address)
    host, sep, port = address.rpartition(":")
    if sep and port.isdigit() and "/" not in address:
        return socketlib.AF_INET, (host or "127.0.0.1", int(port))
    return socketlib.AF_UNIX, address


class SocketSink:
    """Stream records as line-delimited JSON over a socket — the live
    counterpart of `JsonlSink` (one identical JSON line per record, so
    the watch dashboard and the file reader share one wire format).

    The sink CONNECTS (the dashboard listens): pass ``address`` as
    ``"host:port"`` / ``(host, port)`` for TCP or a filesystem path for
    a Unix socket, or hand a pre-connected ``sock`` (tests use a
    socketpair).  After connecting the socket goes non-blocking and
    emit never waits on the reader: unsent bytes queue up to
    ``max_buffer``; a full queue or a dead reader drops the record and
    bumps ``.dropped`` — the run itself never blocks and never sees an
    exception from its telemetry."""

    def __init__(
        self,
        address: str | tuple | None = None,
        *,
        sock: socketlib.socket | None = None,
        connect_timeout: float = 5.0,
        max_buffer: int = 1 << 22,
    ) -> None:
        if (address is None) == (sock is None):
            raise ValueError("pass exactly one of address= or sock=")
        if sock is None:
            family, addr = parse_address(address)
            sock = socketlib.socket(family, socketlib.SOCK_STREAM)
            sock.settimeout(connect_timeout)
            sock.connect(addr)
        sock.setblocking(False)
        self._sock: socketlib.socket | None = sock
        self._pending: list[bytes] = []  # encoded lines not yet fully sent
        self._sent_head = 0              # bytes of _pending[0] already sent
        self._pending_bytes = 0
        self.max_buffer = int(max_buffer)
        self.dropped = 0                 # records lost to backpressure/death
        self._lock = threading.Lock()

    def _flush_locked(self) -> None:
        sock = self._sock
        while self._pending and sock is not None:
            head = self._pending[0]
            try:
                n = sock.send(head[self._sent_head:])
            except (BlockingIOError, InterruptedError):
                return  # reader is slow; keep the queue, try next emit
            except OSError:
                # reader died (EPIPE/ECONNRESET/...): drop everything
                # still queued, count it, and go dead — emit stays a no-op
                # that only counts from here on
                self.dropped += len(self._pending)
                self._pending.clear()
                self._pending_bytes = 0
                self._sent_head = 0
                try:
                    sock.close()
                finally:
                    self._sock = None
                return
            self._sent_head += n
            if self._sent_head >= len(head):
                self._pending.pop(0)
                self._pending_bytes -= len(head)
                self._sent_head = 0

    def emit(self, record: dict) -> None:
        line = (json.dumps(json_safe(record), sort_keys=True) + "\n").encode()
        with self._lock:
            if self._sock is None:
                self.dropped += 1
                return
            if self._pending_bytes + len(line) > self.max_buffer:
                self._flush_locked()  # one drain attempt before dropping
                if self._pending_bytes + len(line) > self.max_buffer:
                    self.dropped += 1
                    return
            self._pending.append(line)
            self._pending_bytes += len(line)
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                # best-effort final drain: give a live reader a beat to
                # take the tail, then drop whatever is left
                try:
                    self._sock.setblocking(True)
                    self._sock.settimeout(1.0)
                    for line in self._pending:
                        self._sock.sendall(line[self._sent_head:])
                        self._sent_head = 0
                except OSError:
                    self.dropped += len(self._pending)
                finally:
                    self._pending.clear()
                    self._pending_bytes = 0
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None

    def __enter__(self) -> "SocketSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def sink_from_spec(spec: str) -> MetricsSink:
    """Build a sink from a CLI spec string — the one parser behind every
    launcher's ``--obs`` flag:

    * ``jsonl:PATH``  -> `JsonlSink(PATH)`;
    * ``socket:ADDR`` -> `SocketSink(ADDR)` (``host:port`` TCP or a
      Unix-socket path — point it at ``python -m repro_torch.obs.watch
      --listen ADDR``);
    * a bare path     -> `JsonlSink` (the common case).

    The ``socket:`` prefix is required for sockets because a bare
    ``host:port`` is indistinguishable from a relative file path with a
    colon in it; ``jsonl:`` exists for symmetry."""
    spec = str(spec)
    scheme, sep, rest = spec.partition(":")
    if sep and scheme == "socket":
        return SocketSink(rest)
    if sep and scheme == "jsonl":
        return JsonlSink(rest)
    return JsonlSink(spec)


class MultiSink:
    """Fan each record out to every wrapped sink, in order."""

    def __init__(self, *sinks: MetricsSink) -> None:
        self.sinks = tuple(sinks)

    def emit(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


class RecordList(list):
    """A plain list of records plus a ``truncated`` flag: True when the
    file ended mid-record (a live `JsonlSink` writer flushed between the
    payload and its newline / mid-line) and the unparseable tail was
    dropped.  Compares equal to an ordinary list, so every existing
    ``read_jsonl(path) == sink.records`` assertion is untouched."""

    truncated: bool = False


def read_jsonl(path: str) -> RecordList:
    """Load a JSONL run back into records (blank lines skipped).

    Crash-/live-safe: an unparseable FINAL line is a partially-written
    record — the clean prefix is returned with ``.truncated = True``
    instead of raising, so `report` and the watch dashboard can read a
    file that is still being appended to.  A bad line with complete
    lines after it is real corruption and still raises."""
    out = RecordList()
    with open(path) as fh:
        lines = fh.read().split("\n")
    for idx, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if any(rest.strip() for rest in lines[idx + 1:]):
                raise  # mid-file corruption, not a live writer's tail
            out.truncated = True
            break
    return out


def iter_jsonl(path: str) -> Iterable[dict]:
    """Stream records from a JSONL file.  Same truncation tolerance as
    `read_jsonl`: a partially-written FINAL line ends the iteration
    cleanly instead of raising (generators cannot carry a flag — use
    `read_jsonl` when the ``truncated`` bit matters)."""
    with open(path) as fh:
        for line in fh:
            complete = line.endswith("\n")
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if complete:
                    raise  # a whole corrupt line, not a truncated tail
                return
            yield rec


def follow_jsonl(
    path: str,
    *,
    poll_s: float = 0.05,
    timeout_s: float | None = None,
    stop: Callable[[], bool] | None = None,
) -> Iterator[dict]:
    """Tail a growing JSONL file, yielding each record as its newline
    lands — the file-backed way to watch a run that is still going
    (``python -m repro_torch.obs.watch run.jsonl``).

    Crash-safe by construction: bytes after the last newline stay in a
    carry buffer until the writer finishes the line, so a mid-record
    flush never produces a parse error.  Waits for ``path`` to exist;
    rewinds if the file shrinks (writer restarted in ``"w"`` mode).
    Ends when ``stop()`` returns True or ``timeout_s`` elapses (None =
    follow forever); a corrupt COMPLETE line still raises."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s

    def expired() -> bool:
        if stop is not None and stop():
            return True
        return deadline is not None and time.monotonic() >= deadline

    while not os.path.exists(path):
        if expired():
            return
        time.sleep(poll_s)
    carry = b""
    pos = 0
    with open(path, "rb") as fh:
        while True:
            try:
                size = os.fstat(fh.fileno()).st_size
            except OSError:
                size = pos
            if size < pos:  # writer truncated/restarted the file
                fh.seek(0)
                pos = 0
                carry = b""
            chunk = fh.read()
            if chunk:
                pos += len(chunk)
                carry += chunk
                *complete, carry = carry.split(b"\n")
                for raw in complete:
                    raw = raw.strip()
                    if raw:
                        yield json.loads(raw)
            elif expired():
                return
            else:
                time.sleep(poll_s)
