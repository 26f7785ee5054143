"""End-to-end run on the PyTorch port: decentralized bilevel TRAINING OF
A TRANSFORMER with C2DFB — the paper's technique applied to the port's LM
stack (``examples/decentralized_llm_bilevel.py``'s twin).

Upper level = backbone (embedding + blocks), lower level = LM head; four
nodes on a ring with heterogeneous synthetic token shards; all inner-loop
traffic is top-k compressed residuals.

    PYTHONPATH=src python examples/decentralized_llm_bilevel_torch.py            # ~20M params
    PYTHONPATH=src python examples/decentralized_llm_bilevel_torch.py --preset 100m
    PYTHONPATH=src python examples/decentralized_llm_bilevel_torch.py --preset smoke --device cpu

Runs on ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises).  The 100m preset is the deployment-scale configuration.
"""

import argparse

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.launch.train import run_bilevel


PRESETS = {
    "smoke": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=512),
    "20m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dims = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"bilevel-lm-{args.preset}", arch_type="dense",
        pattern=("full",), mlp_type="swiglu", **dims,
    )
    steps = args.steps or {"smoke": 5, "20m": 30, "100m": 300}[args.preset]

    ns = argparse.Namespace(
        arch=cfg.name, smoke=False, algo="c2dfb", steps=steps, batch=4,
        seq=128, lr=0.02, nodes=args.nodes, topology="ring", inner_k=5,
        lam=10.0, compressor="topk", ratio=0.2, ckpt_dir=None, seed=0,
    )
    run_bilevel(ns, cfg, device)


if __name__ == "__main__":
    main()
