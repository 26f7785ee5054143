"""Batched serving driver (``repro.launch.serve``'s counterpart): prefill a
batch of prompts, then decode N tokens autoregressively with greedy or
temperature sampling.

Runs on ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises).  Parameters, prompts, stub modality inputs and temperature
samples draw from a ``torch.Generator`` seeded with ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke \\
        --batch 4 --prompt-len 64 --gen 32
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch import normal
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.models.transformer import encoder_forward, init_lm_params, one_node


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument(
        "--obs", default=None, metavar="SPEC",
        help="stream repro_torch.obs timing records: jsonl:PATH, socket:ADDR, or a bare JSONL path",
    )
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    obs = None
    if args.obs:
        from repro_torch.obs import Obs, sink_from_spec

        obs = Obs(sink=sink_from_spec(args.obs), run=f"serve-{args.arch}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_lm_params(cfg, gen)

    B, S, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": prompts}
    memory = None
    if cfg.arch_type == "audio":
        s_enc = max(1, S // cfg.enc_seq_ratio)
        batch["enc_embeds"] = normal(gen, (B, s_enc, cfg.d_model), cfg.dtype)
        with torch.no_grad():
            memory = encoder_forward(one_node(params), cfg, batch["enc_embeds"].unsqueeze(0))[0]
    if cfg.arch_type == "vlm":
        batch["memory"] = normal(gen, (B, cfg.num_patches, cfg.d_model), cfg.dtype)
        memory = batch["memory"]

    prefill = make_prefill_step(cfg, max_len=S + G)
    serve = make_serve_step(cfg)

    _sync(device)
    t0 = time.time()
    logits, caches = prefill(params, batch)
    _sync(device)
    t_prefill = time.time() - t0
    print(f"[serve] prefill {B}x{S} in {t_prefill*1e3:.1f} ms")
    if obs is not None:
        obs.timing("prefill", t_prefill, engine="serve", batch=B, prompt_len=S)

    def sample(logits):
        if args.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    tok = sample(logits)
    generated = [tok]
    t0 = time.time()
    for i in range(G - 1):
        logits, caches = serve(params, tok, S + i, caches, memory)
        tok = sample(logits)
        generated.append(tok)
    _sync(device)
    dt = time.time() - t0
    toks = B * (G - 1)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] decoded {G-1} steps x {B} seqs in {dt:.2f}s ({toks/max(dt, 1e-9):.1f} tok/s on {where})")
    if obs is not None:
        obs.timing("decode", dt, engine="serve", batch=B, gen=G - 1, tokens_per_s=toks / max(dt, 1e-9))
        obs.close()
    out = torch.stack(generated, dim=1)
    print("[serve] sample output ids:", out[0, :16].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
