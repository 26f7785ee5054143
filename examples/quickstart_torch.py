"""Quickstart on the PyTorch port: solve a decentralized bilevel problem
with C2DFB (``examples/quickstart.py``'s twin).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Ten nodes on a ring co-tune per-feature regularization (upper level) for a
linear classifier (lower level), transmitting only top-20% compressed
residuals during the inner loops — the paper's Algorithm 1+2 end to end,
eagerly on ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises).  The data equal the reference's; ``y0`` is a ``torch.Generator``
draw, so the printed numbers are the reference's only where a caller
carries its arrays across (``repro_torch.core.convert.from_numpy``).
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.c2dfb import C2DFBConfig, run
from repro_torch.core.topology import ring
from repro_torch.core.types import node_mean
from repro_torch.data.bilevel_tasks import coefficient_tuning_task


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    m = 10
    bundle = coefficient_tuning_task(m=m, n=1500, p=120, c=5, h=0.8, seed=0, device=device)
    topo = ring(m)
    print(f"ring topology: m={m}, spectral gap rho={topo.spectral_gap:.3f}")

    cfg = C2DFBConfig(
        lam=10.0,
        eta_out=0.2, gamma_out=0.5,
        eta_in=0.2, gamma_in=0.5,
        K=15,
        compressor="topk", comp_ratio=0.2,
    )
    state, metrics = run(
        bundle.problem, topo, cfg, bundle.x0, bundle.y0,
        T=60, generator=torch.Generator(device=device).manual_seed(0), device=device,
    )

    hg = metrics["hypergrad_norm"].cpu().numpy()
    print(f"|hypergradient| final: {hg[-1]:.4f}")
    print(f"x consensus error: {float(metrics['x_consensus_err'][-1]):.2e}")
    acc = bundle.test_accuracy(
        node_mean(state.x), node_mean(state.inner_y.d), bundle.predict_fn
    )
    print(f"test accuracy (5 classes, heterogeneity h=0.8): {acc:.3f}")


if __name__ == "__main__":
    main()
