"""One telemetry spine for every C2DFB execution path, on the PyTorch port
(``examples/observability.py``'s twin).

    PYTHONPATH=src python examples/observability_torch.py [--out DIR] [--device cpu]

Artifacts (the JSONL streams and the Perfetto trace) land in ``--out``
(default: a fresh temporary directory, printed at the end) — never in
the repository root.  The rounds run on ``--device`` (``cuda`` unless
asked for ``cpu``; with no card it raises).

The same six-node coefficient-tuning ring run three ways — the eager
async engine, the compiled runtime (its round bodies replayed from CUDA
graphs on a card, with heartbeats emitted between replays), and the
bit-exact `SimTransport` path — all streaming the SAME per-round record
through one ``obs=`` kwarg.  Shows:

* a JSONL sink + in-memory sink fed simultaneously (`MultiSink`), plus
  a custom sink (`MetricsSink` is a protocol — anything with ``.emit``);
* heartbeats printed mid-run without rebuilding the compiled round;
* the parity contract: the engines' rows are field-for-field equal
  once machine-dependent fields are dropped (`parity_rows`) — and the
  schema-v2 per-NODE rows ride alongside without touching that view;
* the schema-v3 compute meter riding the same rows: per-round
  `oracle_calls` (C2DFB's hvp column is structurally zero — the paper's
  fully-first-order claim as a field) and `compute_flops` (round 0 under
  torch's FLOP counter), priced identically by all three engines;
* a merged Perfetto/Chrome timeline joining the fabric's *simulated*
  per-node lanes, the host's *wall-clock* spans (replay, build, replayed
  rounds), per-node counter lanes from the node rows, and cumulative
  FLOPs/oracle counter lanes from the compute meter — load
  observability_trace.json in ui.perfetto.dev;
* LIVE tailing: a second run streams to a JSONL file from a background
  thread while the foreground follows it crash-safely (`follow_jsonl`)
  and renders the watch dashboard (`python -m repro_torch.obs.watch` is
  the same loop in a terminal; ``--listen`` + `SocketSink` skips the file);
* the report CLI (`python -m repro_torch.obs.report`) summarizing the run.
"""

import argparse
import os
import tempfile
import threading

import torch

from repro_torch import resolve_device
from repro_torch.async_gossip import run_async
from repro_torch.core.c2dfb import C2DFBConfig, run
from repro_torch.core.topology import ring
from repro_torch.data.bilevel_tasks import coefficient_tuning_task
from repro_torch.net import NetTrace, make_fabric
from repro_torch.obs import (
    JsonlSink,
    MemorySink,
    MultiSink,
    Obs,
    follow_jsonl,
    node_rows,
    parity_rows,
)
from repro_torch.obs.report import summarize
from repro_torch.obs.watch import WatchState
from repro_torch.transport import SimTransport


class HeartbeatPrinter:
    """`MetricsSink` is a protocol — anything with ``.emit`` plugs in.
    This one prints the compiled run's liveness samples as they land
    (between its replayed rounds, before the run returns) and forwards
    everything to the wrapped sink."""

    def __init__(self, inner):
        self.inner = inner

    def emit(self, record):
        if record.get("kind") == "heartbeat":
            print(f"  [heartbeat] t={record['round']}  "
                  f"hypergrad={record['hypergrad_norm']:.3e}")
        self.inner.emit(record)

    def close(self):
        self.inner.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--out", default=None, metavar="DIR",
        help="directory for the JSONL/trace artifacts "
        "(default: a fresh temp dir)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = args.out or tempfile.mkdtemp(prefix="observability_")
    os.makedirs(out_dir, exist_ok=True)
    JSONL = os.path.join(out_dir, "observability_run.jsonl")
    LIVE = os.path.join(out_dir, "observability_live.jsonl")
    TRACE = os.path.join(out_dir, "observability_trace.json")

    m, T = 6, 8
    bundle = coefficient_tuning_task(m=m, n=400, p=60, c=4, h=0.8, seed=0, device=device)
    topo = ring(m)
    cfg = C2DFBConfig(
        lam=10.0, eta_out=0.3, gamma_out=0.5, eta_in=0.3, gamma_in=0.3,
        K=4, compressor="topk", comp_ratio=0.5,
    )

    def generator():
        return torch.Generator(device=device).manual_seed(0)

    def fabric(trace=None):
        return make_fabric(
            topo, profile="geo", straggler="lognormal", sigma=0.8,
            compute_s=0.05, seed=0, trace=trace,
        )

    # 1. eager + compiled through ONE handle: memory + JSONL at once.
    # payload_bytes="analytic" makes the eager timing model match the
    # compiled runtime's, so parity below covers sim time and wire bytes
    # too, not just the math.
    mem = MemorySink()
    with JsonlSink(JSONL) as jsonl:
        obs = Obs(sink=HeartbeatPrinter(MultiSink(mem, jsonl)),
                  run="demo", heartbeat_every=2)

        run_async(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T, generator(),
                  fabric(), policy="bounded", bound=2,
                  payload_bytes="analytic", obs=obs, device=device)

        # compiled runtime: the round bodies built once and replayed,
        # heartbeats on, and a NetTrace so the merged timeline gets
        # simulated-time lanes.
        net_trace = NetTrace()
        print("compiled run (heartbeats every 2 rounds):")
        run(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T, generator=generator(), device=device,
            fabric=fabric(net_trace), compiled=True, obs=obs,
            async_mode="bounded", staleness_bound=2)

        # node_records= adds the schema-v2 per-node counter lanes
        # (consensus distance + cumulative egress) under the sim lanes
        obs.save_timeline(TRACE, net_trace, node_records=mem.records)

    # 2. the transport layer with a BARE sink — run() wraps it in a
    # default Obs handle (SimTransport is the bit-exact fabric adapter).
    tmem = MemorySink()
    run(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T, generator=generator(), device=device,
        transport=SimTransport(fabric()), async_mode="bounded",
        staleness_bound=2, compiled=True, obs=tmem)

    # 3. the parity contract: drop the machine-dependent fields
    # (wall_seconds, trace_counts, labels) and the rows are EQUAL.
    rows = {
        eng: parity_rows([r for r in mem.records if r.get("engine") == eng])
        for eng in ("async-eager", "async-compiled")
    }
    rows["transport"] = parity_rows(tmem.records)
    assert rows["async-eager"] == rows["async-compiled"] == rows["transport"]
    print(f"\nparity: eager == compiled == transport on all "
          f"{len(rows['async-eager'])} rounds "
          "(machine-dependent fields excluded)")
    # ...and the v2 node rows rode alongside without touching that view
    per_node = node_rows(mem.records, engine="async-eager", round_idx=T - 1)
    print(f"node rows (schema v2): {len(node_rows(mem.records))} total; "
          "final round per-node egress "
          f"{[r['wire_bytes'] for r in per_node]} bytes")

    # 3b. the compute meter (schema v3): every row that prices the wire
    # also prices the computation — closed-form oracle counts (C2DFB's
    # hvp column is zero BY STRUCTURE) and the FLOPs and dot bytes of the
    # run's own round 0, identical across engines because they run the
    # same round bodies.
    r0 = next(r for r in mem.records
              if r.get("kind") == "round" and r.get("engine") == "async-eager")
    oc = r0["oracle_calls"]
    print("\ncompute meter (per fleet round): "
          + "  ".join(f"{k}={v}" for k, v in oc.items())
          + f"  flops={r0['compute_flops']:.3e}"
          + f"  hbm={r0['hbm_bytes']:.3e}")
    assert oc["hvp"] == 0 and oc["jvp"] == 0  # fully first-order
    assert all(
        r["oracle_calls"] == oc and
        r["compute_flops"] == r0["compute_flops"]
        for r in mem.records + tmem.records if r.get("kind") == "round"
    ), "every engine prices the same round identically"

    # 4. LIVE: tail a run that is still writing.  A background thread
    # streams a fresh run to its own JSONL; the foreground follows the
    # growing file (bytes after the last newline wait in a carry buffer,
    # so a mid-record flush never parses) and feeds the watch dashboard.
    # In a terminal: PYTHONPATH=src python -m repro_torch.obs.watch <file>
    # — or `--listen host:port` with SocketSink(...) on the run's Obs.
    def live_run():
        with JsonlSink(LIVE) as sink:
            run_async(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T,
                      generator(), fabric(), policy="bounded", bound=2,
                      obs=Obs(sink=sink, run="live"), device=device)

    th = threading.Thread(target=live_run)
    th.start()
    state = WatchState()
    seen = 0
    for rec in follow_jsonl(LIVE, timeout_s=300.0,
                            stop=lambda: not th.is_alive()):
        state.ingest(rec)
        seen += 1
    th.join()
    print(f"\n=== live watch: {seen} records tailed while running ===")
    print(state.render(LIVE))

    print(f"\nwrote {JSONL} (one JSON record per line) and {TRACE} "
          "(merged sim+host Perfetto timeline with per-node lanes — "
          "open in ui.perfetto.dev)")
    print("\n=== repro_torch.obs.report summary ===")
    print(summarize(mem.records))
    print("same summary from the file:  PYTHONPATH=src python -m "
          f"repro_torch.obs.report {JSONL}")


if __name__ == "__main__":
    main()
