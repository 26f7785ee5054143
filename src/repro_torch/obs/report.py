"""``python -m repro_torch.obs.report`` — summarize, diff and GATE a JSONL run
(``repro.obs.report``'s counterpart: it reads the reference's JSONL and the
port's alike).

Three modes over the one record schema (`repro_torch.obs.records`):

* ``report run.jsonl``                 per-engine summary: rounds, final
  errors, byte totals by stream, staleness, wall/sim time, heartbeats —
  plus a per-NODE table (schema-v2 ``kind="node"`` rows: each node's
  wire egress, final consensus distance, max age) when the run emitted
  node-resolved records, the schema-v3 compute totals (oracle calls by
  kind, FLOPs, compile/memory), and a bytes-AND-flops-to-target table
  (``--target``) pricing what each engine spent — on both meters — to
  reach a hypergradient-norm threshold;
* ``report a.jsonl --diff b.jsonl``    field-for-field diff of the two
  runs' parity views (`parity_rows`) — machine-dependent fields excluded
  — plus wall-clock deltas reported informationally;
* ``report run.jsonl --gate BENCH_async.json``   regression gate against
  the committed benchmark baseline: jit trace counts EXACT, wire bytes
  EXACT, oracle calls and compute FLOPs EXACT (schema v3 — both are
  claims about the algorithm), warm wall-clock within a machine-tolerant
  band (``--wall-tol``, default 10x; ``--no-wall`` skips the wall check
  for cross-machine use), compile seconds / memory peak advisory-only.
  Exit code 1 on any failure — CI runs this after the perf smoke so a
  byte, retrace, oracle-count or FLOPs regression fails the job.

The gate compares ``kind="gate"`` records (emitted by
``benchmarks/bench_async.py`` / ``benchmarks/bench_transport.py`` at one
FIXED smoke-scale config) against the baseline file's ``"gate"`` block,
so a fresh CI smoke run and the committed baseline are byte-comparable
by construction.  Gate rows without trace counts (the device transport's
eager loop has no jit trace meter) pin bytes and wall clock only — both
sides record ``trace_counts: null`` and the exact comparison still holds.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.records import parity_rows
from repro_torch.obs.sink import read_jsonl

#: summary fields shown per engine (last-round value)
_FINAL_FIELDS = ("hypergrad_norm", "x_consensus_err", "y_consensus_err")


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def summarize(records: list[dict]) -> str:
    """Human-readable multi-engine summary of one JSONL run."""
    out: list[str] = []
    rounds = [r for r in records if r.get("kind") == "round"]
    engines: dict[str, list[dict]] = {}
    for r in rounds:
        engines.setdefault(r.get("engine", "?"), []).append(r)
    for eng, rows in engines.items():
        rows = sorted(rows, key=lambda r: r.get("round", 0))
        last = rows[-1]
        out.append(f"engine {eng}: {len(rows)} rounds")
        for f in _FINAL_FIELDS:
            out.append(f"  final {f:<16} {_fmt(last.get(f))}")
        wire = [r.get("wire_bytes") for r in rows]
        if any(w is not None for w in wire):
            out.append(
                f"  total wire_bytes     "
                f"{sum(w for w in wire if w is not None)}"
            )
        streams: dict[str, int] = {}
        for r in rows:
            for k, v in (r.get("bytes_by_stream") or {}).items():
                streams[k] = streams.get(k, 0) + int(v)
        if streams:
            out.append(
                "  bytes_by_stream      "
                + "  ".join(f"{k}={v}" for k, v in sorted(streams.items()))
            )
        smax = [r.get("staleness_max") for r in rows]
        if any(s is not None for s in smax):
            out.append(
                f"  staleness_max        "
                f"{max(s for s in smax if s is not None)}"
            )
        sims = [r.get("sim_seconds") for r in rows]
        if any(s is not None for s in sims):
            out.append(
                f"  sim_seconds          "
                f"{_fmt(sum(s for s in sims if s is not None))}"
            )
        walls = [r.get("wall_seconds") for r in rows]
        walls = [w for w in walls if w is not None]
        if walls:
            out.append(f"  wall_seconds         {_fmt(sum(walls))}")
        tc = last.get("trace_counts")
        if tc:
            out.append(
                "  trace_counts         "
                + "  ".join(f"{k}={v}" for k, v in sorted(tc.items()))
            )
        # schema-v3 compute meter totals (absent on v1/v2 streams)
        oc_total: dict[str, int] = {}
        for r in rows:
            for k, v in (r.get("oracle_calls") or {}).items():
                oc_total[k] = oc_total.get(k, 0) + int(v)
        if oc_total:
            out.append(
                "  oracle_calls         "
                + "  ".join(f"{k}={v}" for k, v in sorted(oc_total.items()))
            )
        flops = [r.get("compute_flops") for r in rows]
        if any(f is not None for f in flops):
            out.append(
                f"  compute_flops        "
                f"{_fmt(sum(f for f in flops if f is not None))}"
            )
        hbm = [r.get("hbm_bytes") for r in rows]
        if any(h is not None for h in hbm):
            out.append(
                f"  hbm_bytes            "
                f"{_fmt(sum(h for h in hbm if h is not None))}"
            )
        comp = [r.get("compile_seconds") for r in rows]
        comp = [c for c in comp if c is not None]
        if comp:
            out.append(f"  compile_seconds      {_fmt(sum(comp))}")
        mems = [r.get("memory_peak_bytes") for r in rows]
        mems = [mv for mv in mems if mv is not None]
        if mems:
            out.append(f"  memory_peak_bytes    {max(mems)}")
        nrows = [
            r for r in records
            if r.get("kind") == "node" and r.get("engine") == eng
        ]
        if nrows:
            per: dict[int, dict] = {}
            for r in sorted(nrows, key=lambda r: r.get("round", 0)):
                d = per.setdefault(
                    r.get("node", -1),
                    {"wire": 0, "x_dist": None, "smax": 0},
                )
                if r.get("wire_bytes") is not None:
                    d["wire"] += int(r["wire_bytes"])
                if r.get("x_dist") is not None:
                    d["x_dist"] = r["x_dist"]  # last round wins
                if r.get("staleness_max") is not None:
                    d["smax"] = max(d["smax"], int(r["staleness_max"]))
            out.append(
                f"  nodes ({len(per)})"
                "             wire_bytes   final x_dist   max_age"
            )
            for i in sorted(per):
                d = per[i]
                out.append(
                    f"    node {i:<4}         "
                    f"{d['wire']:<12} {_fmt(d['x_dist']):<14} {d['smax']}"
                )
    hb = [r for r in records if r.get("kind") == "heartbeat"]
    if hb:
        out.append(f"heartbeats: {len(hb)}")
    timings = [r for r in records if r.get("kind") == "timing"]
    for r in timings:
        out.append(
            f"timing {r.get('label', '?'):<20} "
            f"{_fmt(r.get('wall_seconds'))} s"
            + (f"  [{r['engine']}]" if r.get("engine") else "")
        )
    gates = [r for r in records if r.get("kind") == "gate"]
    for r in gates:
        out.append(
            f"gate policy={r.get('policy')} wire_bytes={r.get('wire_bytes')} "
            f"traces={r.get('trace_counts')} "
            f"warm_wall_s={_fmt(r.get('warm_wall_s'))}"
            + (
                f" oracle_calls={r.get('oracle_calls')}"
                f" compute_flops={_fmt(r.get('compute_flops'))}"
                if r.get("oracle_calls") is not None else ""
            )
        )
    return "\n".join(out) if out else "(no records)"


def to_target_table(records: list[dict], target: float | None = None) -> str:
    """The bytes-AND-flops-to-target table: what every engine spent on
    BOTH meters — cumulative ``wire_bytes``, ``compute_flops`` and total
    ``oracle_calls`` — up to the first round with ``hypergrad_norm <=
    target``.  With no explicit target, the loosest final hypergradient
    norm across engines is used so every engine reaches it (the paper's
    comparison frame: communication and computation to one accuracy,
    not per-round rates).  Empty string when no round records carry a
    hypergradient norm."""
    rounds = [r for r in records if r.get("kind") == "round"]
    engines: dict[str, list[dict]] = {}
    for r in rounds:
        engines.setdefault(r.get("engine", "?"), []).append(r)
    finals = []
    for rows in engines.values():
        rows.sort(key=lambda r: r.get("round", 0))
        vals = [
            r.get("hypergrad_norm") for r in rows
            if r.get("hypergrad_norm") is not None
        ]
        if vals:
            finals.append(vals[-1])
    if not finals:
        return ""
    if target is None:
        target = max(finals)
    out = [
        f"to-target (hypergrad_norm <= {target:g}):",
        "  engine              rounds  wire_bytes    compute_flops  "
        "oracle_calls",
    ]
    for eng, rows in sorted(engines.items()):
        cum_b, cum_f, cum_oc = 0, 0.0, 0
        hit = None
        for i, r in enumerate(rows):
            cum_b += int(r.get("wire_bytes") or 0)
            f = r.get("compute_flops")
            cum_f += float(f) if f is not None else 0.0
            cum_oc += sum((r.get("oracle_calls") or {}).values())
            h = r.get("hypergrad_norm")
            if h is not None and h <= target:
                hit = i + 1
                break
        status = str(hit) if hit is not None else f">{len(rows)}"
        out.append(
            f"  {eng:<19} {status:<7} {cum_b:<13} "
            f"{_fmt(cum_f):<14} {cum_oc}"
        )
    return "\n".join(out)


def diff(a: list[dict], b: list[dict]) -> tuple[str, bool]:
    """Field-for-field diff of two runs' parity views.  Returns the
    rendered report and whether the algorithmic fields all matched
    (wall-clock deltas never fail a diff — they are machine facts)."""
    pa, pb = parity_rows(a), parity_rows(b)
    out: list[str] = []
    same = True
    if len(pa) != len(pb):
        out.append(f"round count differs: {len(pa)} vs {len(pb)}")
        same = False
    mismatched_fields: dict[str, int] = {}
    for ra, rb in zip(pa, pb):
        keys = sorted(set(ra) | set(rb))
        for k in keys:
            va, vb = ra.get(k), rb.get(k)
            if va != vb:
                same = False
                if mismatched_fields.setdefault(k, 0) == 0:
                    out.append(
                        f"round {ra.get('round')}: {k}: "
                        f"{_fmt(va)} vs {_fmt(vb)}"
                    )
                mismatched_fields[k] += 1
    for k, n in sorted(mismatched_fields.items()):
        out.append(f"field {k}: {n} rounds differ")
    wa = sum(
        r.get("wall_seconds") or 0.0
        for r in a if r.get("kind") == "round"
    )
    wb = sum(
        r.get("wall_seconds") or 0.0
        for r in b if r.get("kind") == "round"
    )
    if wa and wb:
        out.append(
            f"wall_seconds (informational): {_fmt(wa)} vs {_fmt(wb)} "
            f"({wb / wa:.2f}x)"
        )
    out.append("parity: MATCH" if same else "parity: DIFFER")
    return "\n".join(out), same


def gate(
    records: list[dict],
    baseline: dict,
    wall_tol: float = 10.0,
    check_wall: bool = True,
) -> tuple[str, bool]:
    """Gate a run's ``kind="gate"`` records against the baseline file's
    ``"gate"`` block.  Trace counts, wire bytes, oracle calls and
    compute FLOPs are EXACT checks — they are claims about the algorithm
    and the compilation structure, not the machine; warm wall-clock only
    fails outside ``baseline * wall_tol``, and compile seconds / memory
    peak are advisory (printed, never failed on).  Returns
    (report, ok)."""
    out: list[str] = []
    ok = True

    def check(label: str, passed: bool, detail: str) -> None:
        nonlocal ok
        ok = ok and passed
        out.append(f"[{'PASS' if passed else 'FAIL'}] {label}: {detail}")

    block = baseline.get("gate")
    if not isinstance(block, dict) or "policies" not in block:
        return "[FAIL] baseline has no 'gate' block — regenerate it with "\
            "benchmarks/bench_async.py or benchmarks/bench_transport.py", \
            False
    cand = {
        r["policy"]: r for r in records if r.get("kind") == "gate"
    }
    if not cand:
        return "[FAIL] run has no gate records — produce the JSONL with "\
            "benchmarks/bench_async.py or benchmarks/bench_transport.py "\
            "(any flags; the gate rows are always emitted at the fixed "\
            "gate config)", False
    base_cfg = block.get("config", {})
    for policy, base in sorted(block["policies"].items()):
        r = cand.get(policy)
        if r is None:
            check(policy, False, "missing from the candidate run")
            continue
        if base_cfg and r.get("config") not in (None, base_cfg):
            check(
                policy, False,
                f"gate config mismatch: {r.get('config')} vs {base_cfg} — "
                "the two runs priced different problems",
            )
            continue
        check(
            f"{policy}/trace_counts",
            r.get("trace_counts") == base.get("trace_counts"),
            f"{r.get('trace_counts')} vs baseline "
            f"{base.get('trace_counts')} (exact)",
        )
        check(
            f"{policy}/wire_bytes",
            r.get("wire_bytes") == base.get("wire_bytes"),
            f"{r.get('wire_bytes')} vs baseline {base.get('wire_bytes')} "
            "(exact)",
        )
        # schema-v3 compute block: oracle counts and FLOPs are exact
        # claims about the algorithm/compilation; skipped entirely when
        # NEITHER side recorded them (pre-v3 baseline + pre-v3 run)
        base_oc, cand_oc = base.get("oracle_calls"), r.get("oracle_calls")
        if base_oc is not None or cand_oc is not None:
            check(
                f"{policy}/oracle_calls",
                cand_oc == base_oc,
                f"{cand_oc} vs baseline {base_oc} (exact)",
            )
        base_cf, cand_cf = base.get("compute_flops"), r.get("compute_flops")
        if base_cf is not None or cand_cf is not None:
            check(
                f"{policy}/compute_flops",
                cand_cf == base_cf,
                f"{_fmt(cand_cf)} vs baseline {_fmt(base_cf)} (exact)",
            )
        # machine facts: reported, never failed on
        for adv in ("compile_seconds", "memory_peak_bytes"):
            bv, cv = base.get(adv), r.get(adv)
            if bv is not None or cv is not None:
                out.append(
                    f"[INFO] {policy}/{adv}: {_fmt(cv)} vs baseline "
                    f"{_fmt(bv)} (advisory)"
                )
        bw, cw = base.get("warm_wall_s"), r.get("warm_wall_s")
        if not check_wall:
            out.append(f"[SKIP] {policy}/warm_wall_s: --no-wall")
        elif bw is None or cw is None:
            out.append(f"[SKIP] {policy}/warm_wall_s: not recorded")
        else:
            check(
                f"{policy}/warm_wall_s",
                cw <= bw * wall_tol,
                f"{cw:.4f}s vs baseline {bw:.4f}s "
                f"(band: <= {wall_tol:.1f}x)",
            )
    out.append("gate: PASS" if ok else "gate: FAIL")
    return "\n".join(out), ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("jsonl", help="run JSONL written by a JsonlSink")
    p.add_argument(
        "--diff", metavar="OTHER.jsonl",
        help="diff the parity views of two runs (exit 1 on mismatch)",
    )
    p.add_argument(
        "--gate", metavar="BENCH_async.json",
        help="gate the run against the committed benchmark baseline "
        "(exit 1 on regression)",
    )
    p.add_argument(
        "--wall-tol", type=float, default=10.0,
        help="warm wall-clock band for --gate, as a multiple of the "
        "baseline (default 10x — generous because CI machines differ; "
        "trace counts and bytes stay exact)",
    )
    p.add_argument(
        "--no-wall", action="store_true",
        help="skip the wall-clock band in --gate (bytes and trace "
        "counts only)",
    )
    p.add_argument(
        "--target", type=float, default=None,
        help="hypergrad-norm threshold for the bytes-AND-flops-to-target "
        "table (default: the loosest final norm across engines, so every "
        "engine reaches it)",
    )
    args = p.parse_args(argv)

    records = read_jsonl(args.jsonl)
    if args.diff:
        text, ok = diff(records, read_jsonl(args.diff))
        print(text)
        return 0 if ok else 1
    if args.gate:
        with open(args.gate) as f:
            baseline = json.load(f)
        text, ok = gate(
            records, baseline, wall_tol=args.wall_tol,
            check_wall=not args.no_wall,
        )
        print(text)
        return 0 if ok else 1
    print(summarize(records))
    table = to_target_table(records, target=args.target)
    if table:
        print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
