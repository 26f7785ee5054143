#!/usr/bin/env python3
"""Read one benchmark cell's traced rounds by the program's layer spans, on
one CUDA card.

    python3 tools/span_report.py --workload coef-20ng.topk-k10 --seed 7 [--out FILE]

from the root of a checkout.  Builds the cell's program from the seed and
runs its check rounds as a benchmark run does (`perfbench.harness`), traces
the cell's ``trace_rounds`` rounds (`perfbench.trace.profile_rounds`) and
reads them through `perfbench.spans`.  It prints, a round: the device ms
launched inside each layer span, inside ``repro_torch/round`` alone, outside
every span and with no launch record, against the device busy ms; the share
that the layer spans account for; the device records that carry a span's
name; each of the longest kernels' ms by span, and the compressor kernel's
launches by span; the idle gaps by span; and the oracle trace counter
before and after the traced window.  ``--out`` writes the same as JSON.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def report(workload: str, seed: int) -> dict:
    import torch

    from perfbench import harness, spans, spec
    from perfbench.trace import profile_rounds
    from repro_torch.obs.compute import oracle_graph_traces

    _, config, work = spec.load_cell(workload, ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    prog = harness.build_program(config, work, seed, device)
    state, _ = harness.check_rounds(prog)
    box = {"state": state}
    del state

    def one():
        box["state"], _ = harness.step(prog, box["state"])

    before = oracle_graph_traces()
    tr = profile_rounds(one, work["trace_rounds"], device)
    after = oracle_graph_traces()
    att = spans.attribute(tr)
    per_round = lambda s: s * 1e3 / tr.rounds  # noqa: E731
    named = [d for d in tr.device if d[0].startswith(spans.PREFIX)]
    kernels = collections.defaultdict(collections.Counter)
    launches = collections.defaultdict(collections.Counter)
    for name, seconds, span in att.activities:
        kernels[name[:100]][str(span)] += seconds
        launches[name[:100]][str(span)] += 1
    longest = sorted(kernels, key=lambda n: -sum(kernels[n].values()))[:12]
    compressor = [n for n in kernels if "topk_kernel" in n or "quant_kernel" in n]
    return {
        "workload": workload, "seed": seed, "rounds": tr.rounds, "window_ms": per_round(tr.window_s),
        "busy_ms": per_round(tr.busy_s), "activities_ms": per_round(att.total_s),
        "ms_by_span": {str(k): per_round(v) for k, v in sorted(att.seconds.items(), key=lambda kv: -kv[1])},
        "spanned_share": spans.spanned_share(types.SimpleNamespace(trace=tr)),
        "span_named_device_records": [len(named), per_round(sum((b - a) / 1e9 for _, a, b, _ in named))],
        "longest_kernels": {n: {s: per_round(v) for s, v in kernels[n].items()} for n in longest},
        "compressor_launches_a_round": {n: {s: c / tr.rounds for s, c in launches[n].items()} for n in compressor},
        "idle_ms_by_span": {str(k): per_round(v) for k, v in spans.idle_by_span(tr).items()},
        "oracle_traces": {"before": before, "after": after},
        "torch": torch.__version__, "device": torch.cuda.get_device_name(device), "power": harness.power_limit(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    out = report(args.workload, args.seed)
    for k, v in out.items():
        print(f"[spans] {k}: {json.dumps(v)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
