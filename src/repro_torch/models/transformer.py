"""Model assembly, the dense decoder-only LM (``repro.models.transformer``'s
dense path).

Layer stacking as in the reference: the per-layer kind pattern
(``cfg.pattern``, length P) repeats R = num_layers / P times, and the
parameters of pattern position p are STACKED over the R repeats on a
leading ``layers`` axis (behind the node axis: leaves (m, R, ...)).
`forward_hidden` loops over the repeats where the reference scans them,
applying the P block kinds in order; with ``cfg.remat`` each repeat's
blocks are recomputed in the backward pass
(`repro_torch.models.remat.checkpoint`, the reference's
``jax.checkpoint`` with the "nothing" policy).

Block structure (pre-norm residual):
    x += attention(norm(x))
    x += mlp(norm(x))              skipped when d_ff == 0

Mixture-of-experts and Mamba blocks, cross-attention blocks and the
audio encoder are the A10b slice: a config that needs one raises a
NotImplementedError that names it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import tree_map
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    chunked_cross_entropy,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    rms_norm,
)
from repro_torch.models.remat import checkpoint


def check_dense(cfg) -> None:
    """Raise NotImplementedError for what only the A10b slice ports."""
    need = []
    if cfg.num_experts > 0:
        need.append("mixture-of-experts MLPs")
    if "mamba" in cfg.pattern:
        need.append("Mamba (SSM) blocks")
    if "cross" in cfg.pattern or cfg.arch_type in ("audio", "vlm"):
        need.append("cross-attention blocks")
    if cfg.enc_layers > 0:
        need.append("the audio encoder")
    if need:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(need)}: the PyTorch port runs the dense decoder path "
            "(A10a); MoE, SSM and the multimodal paths are slice A10b"
        )
    if cfg.remat and cfg.remat_policy not in ("nothing", "none"):
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: the port recomputes whole repeats (\"nothing\") or nothing "
            "(\"none\")"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(generator: torch.Generator, cfg, p_idx: int) -> dict:
    dev = generator.device
    params = {"norm1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)}
    params["attn"] = attn.attn_init(generator, cfg, cfg.layer_kind(p_idx))
    if cfg.d_ff > 0:
        params["norm2"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
        params["mlp"] = mlp_init(generator, cfg)
    return params


def _stacked_blocks_init(generator: torch.Generator, cfg) -> list:
    """One dict a pattern position, its leaves stacked over the R repeats
    (leading ``layers`` axis); drawn position by position, repeat by
    repeat."""
    blocks = []
    for p in range(len(cfg.pattern)):
        reps = [_block_init(generator, cfg, p) for _ in range(cfg.repeats)]
        blocks.append(tree_map(lambda *vs: torch.stack(vs), reps[0], *reps[1:]))
    return blocks


def init_lm_params(cfg, generator: torch.Generator, device=None) -> dict:
    """One model's parameters, ``{"embed", "blocks": [...], "final_norm",
    "lm_head"}`` (no ``lm_head`` with tied embeddings), drawn from
    ``generator`` (on ``device``; by default the generator's): the
    embedding, the blocks, then the head."""
    check_dense(cfg)
    if device is not None and torch.device(device) != generator.device:
        raise ValueError(f"the generator lies on {generator.device}, the parameters are asked on {device}")
    dev = generator.device
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "blocks": _stacked_blocks_init(generator, cfg),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _apply_block(p: dict, cfg, p_idx: int, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, _ = attn.attn_apply(p["attn"], cfg, h, positions, kind=cfg.layer_kind(p_idx))
    x = x + out
    if cfg.d_ff > 0:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_type)
    return x


def _repeat(x: torch.Tensor, blocks: list, cfg, positions: torch.Tensor) -> torch.Tensor:
    """One repeat: the P block kinds in order."""
    for p_idx, p in enumerate(blocks):
        x = _apply_block(p, cfg, p_idx, x, positions)
    return x


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each node's rows of its own table: embed (m, V, D), tokens (m, ...) ->
    (m, ..., D).  One lookup in the (m * V, D) table, whose backward on the
    card is PyTorch's sorted, segmented ``embedding_dense_backward``: no
    atomics, so two runs give the same bits."""
    m, V = embed.shape[0], embed.shape[1]
    offsets = (torch.arange(m, device=tokens.device) * V).reshape(m, *([1] * (tokens.dim() - 1)))
    return F.embedding(tokens + offsets, embed.reshape(m * V, -1))


def forward_hidden(params: dict, cfg, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (m, B, S) integers -> the final hidden states (m, B, S, D) and
    the auxiliary loss (m,) (zero: dense blocks route nothing)."""
    check_dense(cfg)
    m, B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.sqrt(torch.full((), float(cfg.d_model), dtype=torch.float32, device=x.device)).to(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    remat = cfg.remat and cfg.remat_policy != "none"
    for r in range(cfg.repeats):
        blocks = [tree_map(lambda v: v[:, r], b) for b in params["blocks"]]
        if remat:
            (x,) = checkpoint(_repeat, x, blocks, cfg, positions)
        else:
            x = _repeat(x, blocks, cfg, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((m,), dtype=torch.float32, device=x.device)


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """Each node's LM loss (m,): the cross-entropy of the next token plus
    ``aux_weight`` times the auxiliary loss."""
    hidden, aux = forward_hidden(params, cfg, tokens)
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].transpose(1, 2)
    loss = chunked_cross_entropy(hidden, labels, head, chunk=min(512, tokens.shape[2]), logit_cap=cfg.logit_softcap)
    return loss + aux_weight * aux

