"""Training launcher (``repro.launch.train``'s counterpart).

Two modes, selected by --algo:
* sgd / adamw: standard single-level LM training of any architecture
  config on the synthetic token pipeline.
* c2dfb / c2dfb_nc: the paper's decentralized bilevel algorithm
  (hyper-representation split: backbone = upper level, head = lower
  level), m nodes with heterogeneous shards.  ``c2dfb_nc`` runs C2DFB's
  round too, as the reference's launcher does.

Runs on ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises).  Parameters, stub modality inputs and stochastic compressors draw
from a ``torch.Generator`` seeded with ``--seed``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
        --algo adamw --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke \\
        --algo c2dfb --steps 20 --nodes 4 --topology ring --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, init_state, round_wire_bytes
from repro_torch.core.lm_bilevel import init_node_params, make_lm_bilevel
from repro_torch.core.topology import make_topology
from repro_torch.core.types import node_consensus_dist, node_mean, tree_leaves
from repro_torch.data.synthetic import TokenStream, node_streams
from repro_torch.launch import normal
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_lm_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--algo", default="adamw", choices=["sgd", "adamw", "c2dfb", "c2dfb_nc"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--inner-k", type=int, default=5)
    ap.add_argument("--lam", type=float, default=10.0)
    ap.add_argument("--compressor", default="topk")
    ap.add_argument("--ratio", type=float, default=0.2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument(
        "--obs", default=None, metavar="SPEC",
        help="stream repro_torch.obs telemetry: jsonl:PATH, socket:ADDR (point at `python -m "
        "repro_torch.obs.watch --listen ADDR`), or a bare JSONL path",
    )
    return ap.parse_args(argv)


def run_single_level(args, cfg, device, obs=None):
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm_params(cfg, gen)
    n_params = sum(v.numel() for v in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, algo={args.algo}")
    train_step, opt = make_train_step(cfg, args.algo, lr=args.lr)
    opt_state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    history = []
    t0 = time.time()
    for step, batch in enumerate(stream.batches(args.steps)):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if cfg.arch_type == "audio":
            s_enc = max(1, args.seq // cfg.enc_seq_ratio)
            batch["enc_embeds"] = normal(gen, (args.batch, s_enc, cfg.d_model), cfg.dtype)
        if cfg.arch_type == "vlm":
            batch["memory"] = normal(gen, (args.batch, cfg.num_patches, cfg.d_model), cfg.dtype)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if obs is not None:
            obs.heartbeat(f"train-{args.algo}", step, {"loss": loss})
        print(f"  step {step:4d} loss {loss:.4f}", flush=True)
    dt = time.time() - t0
    print(f"[train] {args.steps} steps in {dt:.1f}s; loss {history[0]:.4f} -> {history[-1]:.4f}")
    if args.ckpt_dir:
        # deferred, as the reference's: a run without --ckpt-dir never imports the checkpoint code
        from repro_torch.checkpoint.io import checkpoint_path, save_pytree

        save_pytree(checkpoint_path(args.ckpt_dir, args.steps), params, step=args.steps, meta={"arch": cfg.name})
        print(f"[train] checkpoint written to {args.ckpt_dir}")
    return history


def run_bilevel(args, cfg, device, obs=None):
    if cfg.tie_embeddings:
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    m = args.nodes
    gen = torch.Generator(device=device).manual_seed(args.seed)
    streams = node_streams(m, cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    val_streams = node_streams(m, cfg.vocab_size, args.seq, args.batch, seed=args.seed + 1)

    def stack(streams):
        bs = [s.next_batch() for s in streams]
        return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device) for k in ("tokens", "labels")}

    data_tr, data_va = stack(streams), stack(val_streams)
    problem = make_lm_bilevel(cfg, data_tr, data_va, m)
    x0, y0 = init_node_params(cfg, gen, m)
    nx = sum(v.numel() for v in tree_leaves(x0)) // m
    ny = sum(v.numel() for v in tree_leaves(y0)) // m
    print(f"[c2dfb] {cfg.name}: upper {nx/1e6:.2f}M / lower {ny/1e6:.3f}M params x {m} nodes, topo={args.topology}")

    topo = make_topology(args.topology, m)
    ccfg = C2DFBConfig(
        lam=args.lam, eta_out=args.lr, gamma_out=0.5, eta_in=args.lr * 3, gamma_in=0.5, K=args.inner_k,
        compressor=args.compressor, comp_ratio=args.ratio,
    )
    state = init_state(problem, ccfg, x0, y0)
    wire = round_wire_bytes(state, ccfg, topo)
    print(f"[c2dfb] wire bytes/round: {wire['total_bytes']/1e6:.2f} MB (inner {wire['inner_bytes']/1e6:.2f} MB)")
    t0 = time.time()
    val0 = None
    for step in range(args.steps):
        state, metrics = c2dfb_round(state, gen, problem, topo, ccfg)
        with torch.no_grad():
            val = float(problem.mean_f(node_mean(state.x), node_mean(state.inner_y.d)))
        val0 = val if val0 is None else val0
        if obs is not None:
            row = {k_: float(v) for k_, v in metrics.items() if v.dim() == 0}
            row["val_loss"] = val
            row["wire_bytes"] = wire["total_bytes"]
            obs.round(f"launch-{args.algo}", step, row)
            # per-node rows: consensus distance and each node's share of the
            # (uniform, synchronous) round egress
            x_nd = node_consensus_dist(state.x).float().cpu().numpy()
            for i in range(m):
                obs.node(f"launch-{args.algo}", step, i, {
                    "x_dist": x_nd[i], "wire_bytes": wire["total_bytes"] // m,
                    "staleness_max": 0, "staleness_mean": 0.0,
                })
        print(
            f"  round {step:4d} val-loss {val:.4f} |hypergrad| {float(metrics['hypergrad_norm']):.5f} "
            f"x-consensus {float(metrics['x_consensus_err']):.3e}",
            flush=True,
        )
    print(f"[c2dfb] {args.steps} rounds in {time.time()-t0:.1f}s; val loss {val0:.4f} -> {val:.4f}")
    if args.ckpt_dir:
        from repro_torch.checkpoint.io import checkpoint_path, save_pytree
        from repro_torch.core.lm_bilevel import merge_params

        params = merge_params(node_mean(state.x), node_mean(state.inner_y.d))
        save_pytree(checkpoint_path(args.ckpt_dir, args.steps), params, step=args.steps,
                    meta={"arch": cfg.name, "algo": "c2dfb"})
    return state


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    obs = None
    if args.obs:
        from repro_torch.obs import Obs, sink_from_spec

        obs = Obs(sink=sink_from_spec(args.obs), run=f"train-{args.arch}")
    try:
        if args.algo in ("sgd", "adamw"):
            return run_single_level(args, cfg, device, obs=obs)
        return run_bilevel(args, cfg, device, obs=obs)
    finally:
        if obs is not None:
            obs.close()


if __name__ == "__main__":
    main()
