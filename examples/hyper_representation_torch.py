"""Paper §6.2 on the PyTorch port — hyper-representation learning:
backbone (UL) vs head (LL) on a synthetic MNIST analogue; C2DFB vs the
naive-compression ablation (``examples/hyper_representation.py``'s twin).

    PYTHONPATH=src python examples/hyper_representation_torch.py [--fast] [--device cpu]

Each round is an eager call on ``--device`` (``cuda`` unless asked for
``cpu``; with no card it raises).  The backbone and head start from
``torch.Generator`` draws, so the numbers are the reference's only where a
caller carries its weights across.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.baselines import c2dfb_nc_init, c2dfb_nc_round
from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, init_state, round_wire_bytes
from repro_torch.core.topology import ring, two_hop
from repro_torch.core.types import node_mean
from repro_torch.data.bilevel_tasks import hyper_representation_task


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m = 10
    T = 15 if args.fast else 60

    bundle = hyper_representation_task(m=m, n=2000, side=12, hidden=32, h=0.8, device=device)
    cfg = C2DFBConfig(lam=10.0, eta_out=0.3, gamma_out=0.3, eta_in=0.5,
                      gamma_in=0.3, K=8, compressor="topk", comp_ratio=0.3)

    for tname, topo in [("ring", ring(m)), ("2hop", two_hop(m))]:
        # reference-point compression (ours)
        state = init_state(bundle.problem, cfg, bundle.x0, bundle.y0)
        gen = torch.Generator(device=device).manual_seed(0)
        for t in range(T):
            state, metrics = c2dfb_round(state, gen, bundle.problem, topo, cfg)
        acc = bundle.test_accuracy(
            node_mean(state.x), node_mean(state.inner_y.d), bundle.predict_fn
        )
        mb = T * round_wire_bytes(state, cfg, topo)["total_bytes"] / 1e6

        # naive error-feedback ablation at identical hyperparameters
        nstate = c2dfb_nc_init(bundle.problem, cfg, bundle.x0, bundle.y0)
        gen = torch.Generator(device=device).manual_seed(0)
        for t in range(T):
            nstate, nmetrics = c2dfb_nc_round(nstate, gen, bundle.problem, topo, cfg)
        nacc = bundle.test_accuracy(
            node_mean(nstate.x), node_mean(nstate.inner_y.d), bundle.predict_fn
        )
        print(f"[{tname}] C2DFB acc={acc:.3f} ({mb:.1f} MB) | "
              f"C2DFB(nc) acc={nacc:.3f} | "
              f"|hg| ours {float(metrics['hypergrad_norm']):.4f} "
              f"vs nc {float(nmetrics['hypergrad_norm']):.4f}")


if __name__ == "__main__":
    main()
