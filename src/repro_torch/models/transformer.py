"""Model assembly: the decoder-only LM (dense, MoE, SSM, hybrid, VLM) and
the optional bidirectional encoder of the audio encoder-decoder
(``repro.models.transformer``'s counterpart).

Layer stacking as in the reference: the per-layer kind pattern
(``cfg.pattern``, length P) repeats R = num_layers / P times, and the
parameters of pattern position p are STACKED over the R repeats on a
leading ``layers`` axis (behind the node axis: leaves (m, R, ...)).
`forward_hidden` loops over the repeats where the reference scans them,
applying the P block kinds in order and summing the blocks' auxiliary
(load-balance) losses; with ``cfg.remat`` each repeat is recomputed in the
backward pass (`repro_torch.models.remat.checkpoint`, the reference's
``jax.checkpoint`` with the "nothing" policy), the running auxiliary loss
and the modality memory inputs of the recomputed region, so the gradient
reaches the encoder through the memory.

Block structure (pre-norm residual):
    x += mixer(norm(x))            mixer: attention of the kind, or Mamba-2
    x += cross_attn(norm(x), mem)  audio decoder blocks only
    x += mlp_or_moe(norm(x))       skipped when d_ff == 0 (pure Mamba-2)

A "cross" pattern position (the VLM's image layers) is an attention
mixer of kind "cross" over the memory (the patches).  Without a memory a
cross attention attends to the text itself, unmasked and without RoPE, as
the reference's does.  MoE layers are the pattern positions where
``cfg.is_moe_layer(p)`` holds (the reference passes the position).  The
audio encoder (``params["encoder"]``) is bidirectional attention and MLP
blocks over the stub frontend's frame embeddings (`encoder_forward`).

The decode path (``init_caches``, ``cache_spec_tree``, ``decode_step``) is
not ported yet; `repro_torch.models.attention` and
`repro_torch.models.ssm` hold each layer's decode step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    chunked_cross_entropy,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    rms_norm,
)
from repro_torch.models.remat import checkpoint


def check_remat(cfg) -> None:
    """Raise NotImplementedError for the ``"dots"`` recompute policy (no
    config uses it): the port recomputes whole repeats ("nothing") or
    nothing ("none")."""
    if cfg.remat and cfg.remat_policy not in ("nothing", "none"):
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r}: the port recomputes whole repeats (\"nothing\") or nothing "
            "(\"none\")"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(generator: torch.Generator, cfg, p_idx: int, with_cross: bool) -> dict:
    """One block of pattern position ``p_idx``: the mixer, the cross
    attention (audio), then the MoE or the MLP, drawn in that order."""
    dev = generator.device
    kind = cfg.layer_kind(p_idx)
    params = {"norm1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)}
    if kind == "mamba":
        params["mamba"] = ssm_mod.mamba_init(generator, cfg)
    else:
        params["attn"] = attn.attn_init(generator, cfg, kind)
    if with_cross:
        params["norm_x"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
        params["cross"] = attn.attn_init(generator, cfg, "cross")
    if cfg.d_ff > 0:
        params["norm2"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
        if cfg.is_moe_layer(p_idx):
            params["moe"] = moe_mod.moe_init(generator, cfg)
        else:
            params["mlp"] = mlp_init(generator, cfg)
    return params


def _stack(reps: list) -> dict:
    return tree_map(lambda *vs: torch.stack(vs), reps[0], *reps[1:])


def _stacked_blocks_init(generator: torch.Generator, cfg, with_cross: bool = False) -> list:
    """One dict a pattern position, its leaves stacked over the R repeats
    (leading ``layers`` axis); drawn position by position, repeat by
    repeat."""
    return [_stack([_block_init(generator, cfg, p, with_cross) for _ in range(cfg.repeats)])
            for p in range(len(cfg.pattern))]


def _enc_block_init(generator: torch.Generator, cfg) -> dict:
    dev = generator.device
    return {
        "norm1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "norm2": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "attn": attn.attn_init(generator, cfg, "bidir"),
        "mlp": mlp_init(generator, cfg),
    }


def init_lm_params(cfg, generator: torch.Generator, device=None) -> dict:
    """One model's parameters, ``{"embed", "blocks": [...], "final_norm",
    "lm_head"}`` (no ``lm_head`` with tied embeddings; plus ``"encoder":
    {"blocks", "final_norm"}`` with an encoder, its blocks' leaves stacked
    over ``enc_layers``), drawn from ``generator`` (on ``device``; by default
    the generator's): the embedding, the blocks, the head, then the
    encoder."""
    check_remat(cfg)
    if device is not None and torch.device(device) != generator.device:
        raise ValueError(f"the generator lies on {generator.device}, the parameters are asked on {device}")
    dev = generator.device
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype),
        # audio decoder blocks carry cross attention
        "blocks": _stacked_blocks_init(generator, cfg, with_cross=cfg.arch_type == "audio"),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, cfg.dtype)
    if cfg.enc_layers > 0:
        params["encoder"] = {
            "blocks": _stack([_enc_block_init(generator, cfg) for _ in range(cfg.enc_layers)]),
            "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _apply_block(p: dict, cfg, p_idx: int, x: torch.Tensor, positions: torch.Tensor, memory=None):
    """One block.  Returns (x, aux): aux (m,) is the block's load-balance
    loss, zeros without a MoE."""
    kind = cfg.layer_kind(p_idx)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba":
        out, _ = ssm_mod.mamba_apply(p["mamba"], cfg, h)
    else:
        out, _ = attn.attn_apply(p["attn"], cfg, h, positions, kind=kind, memory=memory if kind == "cross" else None)
    x = x + out
    if "cross" in p:
        h = rms_norm(x, p["norm_x"], cfg.norm_eps)
        out, _ = attn.attn_apply(p["cross"], cfg, h, positions, kind="cross", memory=memory)
        x = x + out
    if cfg.d_ff > 0:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            out, aux = moe_mod.moe_apply(p["moe"], cfg, h)
        else:
            out = mlp_apply(p["mlp"], h, cfg.mlp_type)
        x = x + out
    return x, aux


def _repeat(x: torch.Tensor, aux: torch.Tensor, blocks: list, cfg, positions: torch.Tensor, memory):
    """One repeat: the P block kinds in order, their aux losses added to
    ``aux``."""
    for p_idx, p in enumerate(blocks):
        x, a = _apply_block(p, cfg, p_idx, x, positions, memory)
        aux = aux + a
    return x, aux


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each node's rows of its own table: embed (m, V, D), tokens (m, ...) ->
    (m, ..., D).  One lookup in the (m * V, D) table, whose backward on the
    card is PyTorch's sorted, segmented ``embedding_dense_backward``: no
    atomics, so two runs give the same bits."""
    m, V = embed.shape[0], embed.shape[1]
    offsets = (torch.arange(m, device=tokens.device) * V).reshape(m, *([1] * (tokens.dim() - 1)))
    return F.embedding(tokens + offsets, embed.reshape(m * V, -1))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward_hidden(params: dict, cfg, tokens: torch.Tensor, memory=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (m, B, S) integers; memory: (m, B, S_mem, D), the encoder's
    output or the image patches, or None -> the final hidden states (m, B,
    S, D) and the auxiliary loss (m,), summed over the blocks."""
    check_remat(cfg)
    m, B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * torch.sqrt(torch.full((), float(cfg.d_model), dtype=torch.float32, device=x.device)).to(cfg.dtype)
    positions = _positions(B, S, tokens.device)
    aux = torch.zeros((m,), dtype=torch.float32, device=x.device)
    remat = cfg.remat and cfg.remat_policy != "none"
    for r in range(cfg.repeats):
        blocks = [tree_map(lambda v: v[:, r], b) for b in params["blocks"]]
        if remat:
            x, aux = checkpoint(_repeat, x, aux, blocks, cfg, positions, memory)
        else:
            x, aux = _repeat(x, aux, blocks, cfg, positions, memory)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _enc_block(x: torch.Tensor, blk: dict, cfg, positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, blk["norm1"], cfg.norm_eps)
    out, _ = attn.attn_apply(blk["attn"], cfg, h, positions, kind="bidir")
    x = x + out
    h = rms_norm(x, blk["norm2"], cfg.norm_eps)
    return x + mlp_apply(blk["mlp"], h, cfg.mlp_type)


def encoder_forward(params: dict, cfg, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over the stub frontend's frame embeddings
    (m, B, S_enc, D) -> (m, B, S_enc, D); each block recomputed in the
    backward pass when ``cfg.remat``, as the reference checkpoints its scan
    body."""
    x = enc_embeds.to(cfg.dtype)
    positions = _positions(x.shape[1], x.shape[2], x.device)
    enc = params["encoder"]
    for layer in range(cfg.enc_layers):
        blk = tree_map(lambda v: v[:, layer], enc["blocks"])
        if cfg.remat:
            (x,) = checkpoint(_enc_block, x, blk, cfg, positions)
        else:
            x = _enc_block(x, blk, cfg, positions)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor, memory=None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Each node's LM loss (m,): the cross-entropy of the next token plus
    ``aux_weight`` times the auxiliary loss."""
    hidden, aux = forward_hidden(params, cfg, tokens, memory=memory)
    head = params["lm_head"] if not cfg.tie_embeddings else params["embed"].transpose(1, 2)
    loss = chunked_cross_entropy(hidden, labels, head, chunk=min(512, tokens.shape[2]), logit_cap=cfg.logit_softcap)
    return loss + aux_weight * aux
