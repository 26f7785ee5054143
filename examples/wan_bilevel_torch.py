"""Decentralized bilevel training over a simulated wide-area network, on
the PyTorch port (``examples/wan_bilevel.py``'s twin).

    PYTHONPATH=src python examples/wan_bilevel_torch.py [--out DIR] [--device cpu]

Ten nodes co-tune per-feature regularization on a ring, but this time the
ring is priced by `repro_torch.net`: every compressed residual is
serialized by the wire codec (exact integer bytes), pushed through a WAN
link model with lognormal compute stragglers, and the whole timeline is
exported as a JSON trace.  A flaky-link variant shows time-varying
topologies plugging into the same run.  The rounds run eagerly on
``--device`` (``cuda`` unless asked for ``cpu``; with no card it raises);
the fabric and the codec's byte assembly are host numpy.
"""

import argparse
import json
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.core.c2dfb import C2DFBConfig, run
from repro_torch.core.topology import ring
from repro_torch.core.types import node_mean
from repro_torch.data.bilevel_tasks import coefficient_tuning_task
from repro_torch.net import LinkDropoutSchedule, NetTrace, make_fabric


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--out", default=None, metavar="DIR",
        help="directory for the exported trace (default: a temp dir)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = args.out or tempfile.mkdtemp(prefix="wan_bilevel_")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "wan_trace.json")

    m, T = 10, 30
    bundle = coefficient_tuning_task(m=m, n=1500, p=120, c=5, h=0.8, seed=0, device=device)
    topo = ring(m)
    cfg = C2DFBConfig(
        lam=10.0, eta_out=0.2, gamma_out=0.5, eta_in=0.2, gamma_in=0.5,
        K=15, compressor="topk", comp_ratio=0.2,
    )

    # ---- WAN fabric: 100 Mbit links, 30 ms latency, straggling nodes ------
    trace = NetTrace()
    fabric = make_fabric(
        topo, profile="wan", straggler="lognormal", sigma=0.6,
        compute_s=0.02, seed=0, trace=trace,
    )
    state, mets = run(
        bundle.problem, topo, cfg, bundle.x0, bundle.y0,
        T=T, generator=torch.Generator(device=device).manual_seed(0), device=device, fabric=fabric,
    )
    acc = bundle.test_accuracy(
        node_mean(state.x), node_mean(state.inner_y.d), bundle.predict_fn
    )
    total_mb = mets["wire_bytes"].sum() / 1e6  # host numpy (int64 and float64), as the reference's
    total_s = mets["sim_seconds"].sum()
    print(f"WAN ring, m={m}: accuracy {acc:.3f} after {T} rounds")
    print(f"  codec-measured traffic: {total_mb:.2f} MB "
          f"({int(mets['wire_bytes'][0])} B/round, exact integers)")
    print(f"  simulated wall clock:   {total_s:.1f} s "
          f"(mean round {total_s / T * 1e3:.0f} ms)")

    with open(trace_path, "w") as fh:
        json.dump(trace.to_json(), fh)
    print(f"  timeline: {trace_path} ({len(trace.transfers)} transfers; "
          "chrome=True for chrome://tracing)")

    # ---- same run over flaky links (20% dropout per round) ----------------
    sched = LinkDropoutSchedule(topo, p_drop=0.2, seed=1)
    state2, mets2 = run(
        bundle.problem, topo, cfg, bundle.x0, bundle.y0,
        T=T, generator=torch.Generator(device=device).manual_seed(0), device=device, schedule=sched,
    )
    acc2 = bundle.test_accuracy(
        node_mean(state2.x), node_mean(state2.inner_y.d), bundle.predict_fn
    )
    err = float(mets2["x_consensus_err"][-1])
    print(f"flaky links (20% dropout): accuracy {acc2:.3f}, "
          f"final consensus err {err:.2e}")


if __name__ == "__main__":
    main()
