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
``jax.checkpoint`` with its ``cfg.remat_policy``, "nothing" or "dots"),
the running auxiliary loss and the modality memory inputs of the
recomputed region, so the gradient reaches the encoder through the
memory.  The activations pass `shard_activation` where the reference's
do: after the embedding and after every block.

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

The decode path (`init_caches`, `cache_spec_tree`, `decode_step`) works on
ONE model, as the reference's does: parameters, tokens and caches without
the node axis (cache leaves (R, B, ...), stacked over the repeats; a cross
position keeps a 1-slot cache, since its memory is fixed).  Inside, it
gives the node-stacked layer functions a node axis of 1 (`one_node`, a
view) and takes it off their caches again (`cache_on_node`,
`cache_off_node`: every cache leaf but ``slot_pos`` carries the node axis
in `repro_torch.models.attention` and `repro_torch.models.ssm`).  Each
repeat's new caches are stacked again, as the reference's scan stacks
them; ``pos`` is a Python integer (the absolute position of the token).

Initialization fills each stacked (R, ...) leaf repeat by repeat
(`_stacked`), so building a model holds one repeat's block beside the
stack, not every repeat twice (gemma2-27b's blocks are 52 GB in bf16).
The inits return each leaf's logical axes beside it, as the reference's
do; `abstract_lm_params` gives the shapes (meta tensors) and the axes
without drawing or allocating.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.types import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    chunked_cross_entropy,
    dense_init,
    embed_init,
    head_linear,
    init_device,
    linear,
    mlp_apply,
    mlp_init,
    norm_init,
    rms_norm,
    shard_activation,
    softcap,
)
from repro_torch.models.remat import checkpoint
from repro_torch.models.sharded import batch_positions, is_dtensor, vocab_parallel_embedding


def check_remat(cfg) -> None:
    """Raise ValueError for a recompute policy the reference does not
    have (it has "nothing", "dots" and "none")."""
    if cfg.remat and cfg.remat_policy not in ("nothing", "dots", "none"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: have \"nothing\", \"dots\" and \"none\"")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(generator, cfg, p_idx: int, with_cross: bool) -> tuple[dict, dict]:
    """One block of pattern position ``p_idx`` and its axes: the mixer, the
    cross attention (audio), then the MoE or the MLP, drawn in that
    order."""
    dev = init_device(generator)
    kind = cfg.layer_kind(p_idx)
    params, specs = {}, {}
    params["norm1"], specs["norm1"] = norm_init(cfg.d_model, cfg.dtype, dev)
    if kind == "mamba":
        params["mamba"], specs["mamba"] = ssm_mod.mamba_init(generator, cfg)
    else:
        params["attn"], specs["attn"] = attn.attn_init(generator, cfg, kind)
    if with_cross:
        params["norm_x"], specs["norm_x"] = norm_init(cfg.d_model, cfg.dtype, dev)
        params["cross"], specs["cross"] = attn.attn_init(generator, cfg, "cross")
    if cfg.d_ff > 0:
        params["norm2"], specs["norm2"] = norm_init(cfg.d_model, cfg.dtype, dev)
        if cfg.is_moe_layer(p_idx):
            params["moe"], specs["moe"] = moe_mod.moe_init(generator, cfg)
        else:
            params["mlp"], specs["mlp"] = mlp_init(generator, cfg)
    return params, specs


def _stacked(draw, n: int) -> tuple[dict, dict]:
    """``n`` draws of ``draw()`` (a tree and its axes), stacked on a leading
    ``layers`` axis: each stacked leaf is allocated once and filled draw by
    draw, so only one draw's tree lives beside the stack.  The values are
    ``torch.stack``'s; the axes gain ``"layers"`` in front."""
    first, specs = draw()
    out = tree_map(lambda v: v.new_empty((n, *v.shape)), first)
    tree_map(lambda o, v: o[0].copy_(v), out, first)
    del first
    for r in range(1, n):
        tree_map(lambda o, v: o[r].copy_(v), out, draw()[0])
    return out, tree_map(lambda ax: ("layers", *ax), specs)


def _stacked_blocks_init(generator, cfg, with_cross: bool = False) -> tuple[list, list]:
    """One dict a pattern position, its leaves stacked over the R repeats
    (leading ``layers`` axis), and their axes; drawn position by position,
    repeat by repeat."""
    stacks = [_stacked(lambda: _block_init(generator, cfg, p, with_cross), cfg.repeats)
              for p in range(len(cfg.pattern))]
    return [b for b, _ in stacks], [s for _, s in stacks]


def _enc_block_init(generator, cfg) -> tuple[dict, dict]:
    dev = init_device(generator)
    p, s = {}, {}
    p["norm1"], s["norm1"] = norm_init(cfg.d_model, cfg.dtype, dev)
    p["norm2"], s["norm2"] = norm_init(cfg.d_model, cfg.dtype, dev)
    p["attn"], s["attn"] = attn.attn_init(generator, cfg, "bidir")
    p["mlp"], s["mlp"] = mlp_init(generator, cfg)
    return p, s


def _init_lm(cfg, generator) -> tuple[dict, dict]:
    """`init_lm_params`' tree and the axes of its leaves; with
    ``generator=None``, meta tensors (no draw, no allocation)."""
    dev = init_device(generator)
    params, specs = {}, {}
    params["embed"], specs["embed"] = embed_init(generator, cfg.vocab_size, cfg.d_model, cfg.dtype)
    # audio decoder blocks carry cross attention
    params["blocks"], specs["blocks"] = _stacked_blocks_init(generator, cfg, with_cross=cfg.arch_type == "audio")
    params["final_norm"], specs["final_norm"] = norm_init(cfg.d_model, cfg.dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"], specs["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, "embed", "vocab",
                                                         cfg.dtype)
    if cfg.enc_layers > 0:
        blocks, bspecs = _stacked(lambda: _enc_block_init(generator, cfg), cfg.enc_layers)
        final, fspec = norm_init(cfg.d_model, cfg.dtype, dev)
        params["encoder"], specs["encoder"] = {"blocks": blocks, "final_norm": final}, \
            {"blocks": bspecs, "final_norm": fspec}
    return params, specs


def init_lm_params(cfg, generator: torch.Generator, device=None) -> dict:
    """One model's parameters, ``{"embed", "blocks": [...], "final_norm",
    "lm_head"}`` (no ``lm_head`` with tied embeddings; plus ``"encoder":
    {"blocks", "final_norm"}`` with an encoder, its blocks' leaves stacked
    over ``enc_layers``), drawn from ``generator`` (on ``device``; by default
    the generator's): the embedding, the blocks, the head, then the
    encoder.  `abstract_lm_params` gives their shapes and axes."""
    check_remat(cfg)
    if device is not None and torch.device(device) != generator.device:
        raise ValueError(f"the generator lies on {generator.device}, the parameters are asked on {device}")
    return _init_lm(cfg, generator)[0]


def abstract_lm_params(cfg) -> tuple[dict, dict]:
    """(the parameter tree as ``meta`` tensors, the tree of their logical
    axes): `init_lm_params`' shapes and dtypes, with no draw and no
    allocation; the reference's ``jax.eval_shape`` of its init."""
    check_remat(cfg)
    return _init_lm(cfg, None)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _block(p: dict, cfg, x: torch.Tensor, mixer, cross):
    """One block, pre-norm residual: x += mixer(norm1(x)); x +=
    cross(p["cross"], norm_x(x)) (audio decoder blocks); x +=
    mlp_or_moe(norm2(x)).  ``mixer(h)`` returns (out, state): the mixer's
    second output (its k and v, or a Mamba layer's state or cache) comes
    back as the third result.  Returns (x, aux, state): aux (m,) is the
    block's load-balance loss, zeros without a MoE."""
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    out, state = mixer(rms_norm(x, p["norm1"], cfg.norm_eps))
    x = x + out
    if "cross" in p:
        x = x + cross(p["cross"], rms_norm(x, p["norm_x"], cfg.norm_eps))
    if cfg.d_ff > 0:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            out, aux = moe_mod.moe_apply(p["moe"], cfg, h)
        else:
            out = mlp_apply(p["mlp"], h, cfg.mlp_type)
        x = x + out
    return x, aux, state


def _mixer(p: dict, cfg, p_idx: int, positions: torch.Tensor, memory, return_cache: bool = False):
    """Pattern position ``p_idx``'s train / prefill mixer over ``p``'s
    weights: attention of its kind (a cross position over ``memory``), or
    Mamba-2 (its decode cache with ``return_cache``)."""
    kind = cfg.layer_kind(p_idx)
    if kind == "mamba":
        return lambda h: ssm_mod.mamba_apply(p["mamba"], cfg, h, return_cache=return_cache)
    mem = memory if kind == "cross" else None
    return lambda h: attn.attn_apply(p["attn"], cfg, h, positions, kind=kind, memory=mem)


def _cross(cfg, positions: torch.Tensor, memory):
    """The audio decoder's cross sublayer over ``memory``."""
    return lambda w, h: attn.attn_apply(w, cfg, h, positions, kind="cross", memory=memory)[0]


def _apply_block(p: dict, cfg, p_idx: int, x: torch.Tensor, positions: torch.Tensor, memory=None):
    """One block.  Returns (x, aux): aux (m,) is the block's load-balance
    loss, zeros without a MoE."""
    x, aux, _ = _block(p, cfg, x, _mixer(p, cfg, p_idx, positions, memory), _cross(cfg, positions, memory))
    return x, aux


def _repeat(x: torch.Tensor, aux: torch.Tensor, blocks: list, cfg, positions: torch.Tensor, memory):
    """One repeat: the P block kinds in order, their aux losses added to
    ``aux``."""
    for p_idx, p in enumerate(blocks):
        x, a = _apply_block(p, cfg, p_idx, x, positions, memory)
        x = shard_activation(x)
        aux = aux + a
    return x, aux


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each node's rows of its own table: embed (m, V, D), tokens (m, ...) ->
    (m, ..., D).  One lookup in the (m * V, D) table, whose backward on the
    card is PyTorch's sorted, segmented ``embedding_dense_backward``: no
    atomics, so two runs give the same bits.  A DTensor table is looked up
    on its vocabulary shards (`repro_torch.models.sharded.
    vocab_parallel_embedding`)."""
    if is_dtensor(embed):
        return vocab_parallel_embedding(embed, tokens, embed_tokens)
    m, V = embed.shape[0], embed.shape[1]
    offsets = (torch.arange(m, device=tokens.device) * V).reshape(m, *([1] * (tokens.dim() - 1)))
    return F.embedding(tokens + offsets, embed.reshape(m * V, -1))


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The input embeddings of ``tokens`` (m, ...): each node's rows, in the
    model's dtype (through `shard_activation`), times sqrt(d_model) with
    ``cfg.scale_embed``."""
    x = shard_activation(embed_tokens(params["embed"], tokens).to(cfg.dtype))
    if cfg.scale_embed:
        x = x * torch.sqrt(torch.full((), float(cfg.d_model), dtype=torch.float32, device=x.device)).to(cfg.dtype)
    return x


def lm_head(params: dict, cfg) -> torch.Tensor:
    """The output projection (m, D, V): ``lm_head``, or the embedding's
    transpose with tied embeddings."""
    return params["lm_head"] if not cfg.tie_embeddings else params["embed"].transpose(1, 2)


def head_logits(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits of final hidden states x (m, B, D): the head product in the
    model's dtype, cast to f32, soft-capped."""
    return softcap(head_linear(x, lm_head(params, cfg), serve=True).to(torch.float32), cfg.logit_softcap)


def _positions(B: int, S: int, device, like=None) -> torch.Tensor:
    """(B, S) positions, ``arange(S)`` a row; for a DTensor ``like`` (m, B,
    ...), a DTensor sharded as its batch."""
    if is_dtensor(like):
        return batch_positions(like, S)
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward_hidden(params: dict, cfg, tokens: torch.Tensor, memory=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (m, B, S) integers; memory: (m, B, S_mem, D), the encoder's
    output or the image patches, or None -> the final hidden states (m, B,
    S, D) and the auxiliary loss (m,), summed over the blocks."""
    check_remat(cfg)
    m, B, S = tokens.shape
    x = embed(params, cfg, tokens)
    positions = _positions(B, S, tokens.device, like=x)
    aux = torch.zeros((m,), dtype=torch.float32, device=x.device)
    remat = cfg.remat and cfg.remat_policy != "none"
    for r in range(cfg.repeats):
        blocks = [tree_map(lambda v: v[:, r], b) for b in params["blocks"]]
        if remat:
            x, aux = checkpoint(_repeat, x, aux, blocks, cfg, positions, memory, policy=cfg.remat_policy)
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
    x = shard_activation(enc_embeds.to(cfg.dtype))
    positions = _positions(x.shape[1], x.shape[2], x.device, like=x)
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
    loss = chunked_cross_entropy(hidden, labels, lm_head(params, cfg), chunk=min(512, tokens.shape[2]), logit_cap=cfg.logit_softcap)
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# decode (one model: no node axis)
# ---------------------------------------------------------------------------


def one_node(tree):
    """One model's tree as a view with a node axis of 1 (leaves (1, ...))."""
    return tree_map(lambda v: v.unsqueeze(0), tree)


def cache_on_node(cache: dict) -> dict:
    """One layer's cache without the node axis -> the layer functions'
    layout: every leaf but ``slot_pos`` gains a node axis of 1 (a view)."""
    return {k: v if k == "slot_pos" else v.unsqueeze(0) for k, v in cache.items()}


def cache_off_node(cache: dict) -> dict:
    """The inverse of `cache_on_node`."""
    return {k: v if k == "slot_pos" else v[0] for k, v in cache.items()}


def stack_repeats(per_repeat: list) -> dict:
    """One pattern position's caches of the R repeats -> leaves (R, ...)."""
    return {k: torch.stack([c[k] for c in per_repeat]) for k in per_repeat[0]}


def init_caches(cfg, batch: int, s_max: int, dtype=None, device=None) -> list:
    """Zero decode caches, a dict a pattern position, leaves (R, ...)
    stacked over the repeats: attention k and v (R, B, size, KV, hd) with
    ``slot_pos`` (R, size) all -1 (size s_max, or the window of a
    sliding-window layer; 1 at a cross position), a Mamba layer's f32 state
    (R, B, H, P, N) and conv inputs (R, B, D_CONV - 1, conv_dim).  On
    ``cuda`` unless ``device`` says otherwise (without a card it raises);
    ``device="meta"`` allocates nothing."""
    device = torch.device("meta") if device is not None and torch.device(device).type == "meta" \
        else resolve_device(device)
    R = cfg.repeats
    caches = []
    for p_idx in range(len(cfg.pattern)):
        kind = cfg.layer_kind(p_idx)
        if kind == "mamba":
            one = ssm_mod.make_ssm_cache(cfg, 1, batch, dtype, device=device)
        elif kind == "cross":
            one = attn.make_cache(cfg, 1, batch, 1, kind="full", dtype=dtype, device=device)
        else:
            one = attn.make_cache(cfg, 1, batch, s_max, kind=kind, dtype=dtype, device=device)
        caches.append({k: v.unsqueeze(0).expand(R, *v.shape).clone() for k, v in cache_off_node(one).items()})
    return caches


def cache_spec_tree(cfg) -> list:
    """The cache tree's logical axes, the reference's: ``("layers", ...)``
    in front of each layer's."""
    out = []
    for p_idx in range(len(cfg.pattern)):
        kind = cfg.layer_kind(p_idx)
        s = ssm_mod.ssm_cache_specs() if kind == "mamba" else attn.cache_specs(kind)
        out.append({k: ("layers",) + tuple(ax) for k, ax in s.items()})
    return out


def _decode_mixer(p: dict, cfg, p_idx: int, cache: dict, pos: int, memory):
    kind = cfg.layer_kind(p_idx)
    if kind == "mamba":
        return lambda h: ssm_mod.mamba_decode(p["mamba"], cfg, h, cache)
    mem = memory if kind == "cross" else None
    return lambda h: attn.attn_decode(p["attn"], cfg, h, cache, pos, kind=kind, memory=mem)


@torch.no_grad()
def decode_step(params: dict, cfg, token: torch.Tensor, caches: list, pos: int, memory=None):
    """One-token decode through the whole stack, for one model.

    token: (B,) integers; caches as from `init_caches` or the prefill; pos:
    the token's absolute position; memory: (B, S_mem, D), the encoder's
    output or the image patches, or None.  Returns (logits (B, V) f32,
    new caches); the caches given are not changed."""
    pos = int(pos)
    p1 = one_node(params)
    x = embed(p1, cfg, token.reshape(1, -1, 1))
    mem = None if memory is None else memory.unsqueeze(0)
    cross = lambda w, h: attn.attn_decode(w, cfg, h, None, pos, kind="cross", memory=mem)[0]  # noqa: E731
    new = [[] for _ in cfg.pattern]
    for r in range(cfg.repeats):
        for p_idx, stacked in enumerate(p1["blocks"]):
            blk = tree_map(lambda v: v[:, r], stacked)
            cache = cache_on_node({k: v[r] for k, v in caches[p_idx].items()})
            x, _, cache = _block(blk, cfg, x, _decode_mixer(blk, cfg, p_idx, cache, pos, mem), cross)
            x = shard_activation(x)
            new[p_idx].append(cache_off_node(cache))
    x = rms_norm(x, p1["final_norm"], cfg.norm_eps)
    return head_logits(p1, cfg, x[:, :, 0])[0], [stack_repeats(c) for c in new]
