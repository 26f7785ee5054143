"""Paper §6.1 on the PyTorch port — coefficient tuning, C2DFB vs
second-order baselines over three topologies (ring / 2-hop / ER), iid and
heterogeneous splits (``examples/coefficient_tuning.py``'s twin).

    PYTHONPATH=src python examples/coefficient_tuning_torch.py [--fast] [--device cpu]

Prints accuracy-vs-communication trajectories (the data behind the paper's
Figure 2 / Table 1).  Each round is an eager call on ``--device`` (``cuda``
unless asked for ``cpu``; with no card it raises); C2DFB's rounds take a
``torch.Generator``, which top-k never draws from.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.baselines import (
    MADSBOConfig, MDBOConfig, madsbo_init, madsbo_round,
    madsbo_round_wire_bytes, mdbo_init, mdbo_round, mdbo_round_wire_bytes,
)
from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, init_state, round_wire_bytes
from repro_torch.core.topology import erdos_renyi, ring, two_hop
from repro_torch.core.types import node_mean
from repro_torch.data.bilevel_tasks import coefficient_tuning_task


def run_c2dfb(bundle, topo, T, generator):
    cfg = C2DFBConfig(lam=10.0, eta_out=0.5, gamma_out=0.5, eta_in=0.3,
                      gamma_in=0.5, K=10, compressor="topk", comp_ratio=0.2)
    state = init_state(bundle.problem, cfg, bundle.x0, bundle.y0)
    bytes_per_round = round_wire_bytes(state, cfg, topo)["total_bytes"]
    traj = []
    for t in range(T):
        state, _ = c2dfb_round(state, generator, bundle.problem, topo, cfg)
        if t % 5 == 4:
            acc = bundle.test_accuracy(
                node_mean(state.x), node_mean(state.inner_y.d), bundle.predict_fn
            )
            traj.append(((t + 1) * bytes_per_round / 1e6, acc))
    return traj


def run_mdbo(bundle, topo, T, generator):
    cfg = MDBOConfig(eta_x=0.05, eta_y=0.1, gamma=0.5, K=10, neumann_N=10,
                     neumann_eta=0.1)
    state = mdbo_init(bundle.x0, bundle.y0)
    bpr = mdbo_round_wire_bytes(state, cfg, topo)
    traj = []
    for t in range(T):
        state, _ = mdbo_round(state, bundle.problem, topo, cfg)
        if t % 5 == 4:
            acc = bundle.test_accuracy(
                node_mean(state.x), node_mean(state.y), bundle.predict_fn
            )
            traj.append(((t + 1) * bpr / 1e6, acc))
    return traj


def run_madsbo(bundle, topo, T, generator):
    cfg = MADSBOConfig(eta_x=0.05, eta_y=0.1, eta_v=0.05, gamma=0.5, K=10, Q=10)
    state = madsbo_init(bundle.problem, bundle.x0, bundle.y0)
    bpr = madsbo_round_wire_bytes(state, cfg, topo)
    traj = []
    for t in range(T):
        state, _ = madsbo_round(state, bundle.problem, topo, cfg)
        if t % 5 == 4:
            acc = bundle.test_accuracy(
                node_mean(state.x), node_mean(state.y), bundle.predict_fn
            )
            traj.append(((t + 1) * bpr / 1e6, acc))
    return traj


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--hetero", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = 10
    T = 20 if args.fast else 60
    generator = torch.Generator(device=device).manual_seed(0)

    topos = {"ring": ring(m), "2hop": two_hop(m), "er0.4": erdos_renyi(m, 0.4, 0)}
    for h in ([args.hetero] if args.fast else [0.0, args.hetero]):
        bundle = coefficient_tuning_task(m=m, n=1500, p=120, c=5, h=h, seed=0, device=device)
        print(f"\n== heterogeneity h={h} ==")
        for tname, topo in topos.items():
            rows = {}
            rows["C2DFB"] = run_c2dfb(bundle, topo, T, generator)
            rows["MADSBO"] = run_madsbo(bundle, topo, T, generator)
            rows["MDBO"] = run_mdbo(bundle, topo, T, generator)
            print(f"-- topology {tname} (rho={topo.spectral_gap:.3f})")
            for name, traj in rows.items():
                mb, acc = traj[-1]
                print(f"   {name:8s} final acc {acc:.3f} @ {mb:9.2f} MB"
                      f" | acc@{traj[0][0]:.1f}MB = {traj[0][1]:.3f}")


if __name__ == "__main__":
    main()
