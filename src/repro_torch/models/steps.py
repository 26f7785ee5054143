"""Step factories (``repro.models.steps``'s counterpart): the functions the
launchers call.

* train_step(params, opt_state, batch)        -> (params, opt_state, metrics)
* prefill_step(params, batch)                 -> (last_logits, caches)
* serve_step(params, token, pos, caches, ...) -> (logits, new_caches)

The steps take ONE model's parameters (no node axis) and (B, S) tokens, as
the reference's do, so their trees match the reference's leaf for leaf;
inside, they give the node-stacked model functions a node axis of 1
(`repro_torch.models.transformer.one_node`, a view) and take it off again.
The caches carry no node axis either (`repro_torch.models.transformer`).

The train step is the reference's ``value_and_grad`` of ``lm_loss``, then
global-norm clipping, then the optimizer: the gradient by plain autograd
(each checkpointed repeat recomputed once in the backward pass), the
clipping and the update in place (`repro_torch.optim`), so it returns the
parameters and state it was given, updated.  Prefill and decode run under
``torch.no_grad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import transformer as T
from repro_torch.optim import clip_by_global_norm, make_optimizer


def _memory_from_batch(params, cfg, batch):
    """The cross attention's memory, node-stacked (1, B, S_mem, D), for
    node-stacked ``params``: an audio model's encoder output over
    ``batch["enc_embeds"]`` (or ``batch["memory"]`` when given), a VLM's
    patches ``batch["memory"]``; None otherwise."""
    if cfg.arch_type == "audio":
        if "memory" in batch:
            return batch["memory"].unsqueeze(0)
        return T.encoder_forward(params, cfg, batch["enc_embeds"].unsqueeze(0))
    if cfg.arch_type == "vlm":
        return batch["memory"].unsqueeze(0)
    return None


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient (the dry run's sharded step) brought to its
    parameter's placements, a Partial sum reduced, as the reference's
    gradient takes its parameter's sharding; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, optimizer_name: str = "adamw", lr: float = 3e-4, clip: float = 1.0,
                    moment_dtype=torch.float32):
    opt = make_optimizer(optimizer_name, moment_dtype=moment_dtype)

    def train_step(params, opt_state, batch):
        live = [v.detach().requires_grad_() for v in tree_leaves(params)]
        p1 = T.one_node(tree_unflatten(params, live))
        memory = _memory_from_batch(p1, cfg, batch)
        loss = T.lm_loss(p1, cfg, batch["tokens"].unsqueeze(0), batch["labels"].unsqueeze(0), memory=memory)[0]
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        grads = [_placed_like(g, v) for g, v in zip(grads, live)]
        del live, p1, memory
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads), clip)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, opt


def _prefill_cache(cfg, kind: str, state, S: int, max_len) -> dict:
    """One layer's decode cache from its prefill (no node axis): a Mamba
    layer's state and conv inputs; a cross layer's 1-slot dummy (its memory
    is fixed); a sliding-window layer's last min(window, S) keys and values
    in ring order (slot j holds the latest position p with p % size == j);
    else the keys and values padded to max(max_len, S) slots, the padding's
    ``slot_pos`` -1."""
    if kind == "mamba":
        return T.cache_off_node(state)
    k, v = state[0][0], state[1][0]  # (B, S, KV, hd)
    dev = k.device
    if kind == "cross":
        B = k.shape[0]
        return {"k": k.new_zeros((B, 1, *k.shape[2:])), "v": v.new_zeros((B, 1, *v.shape[2:])),
                "slot_pos": torch.full((1,), -1, dtype=torch.int32, device=dev)}
    if kind == "swa" and cfg.window:
        size = min(cfg.window, S)
        kept = torch.arange(S, dtype=torch.int32, device=dev)[-size:]
        order = torch.argsort(kept % size)
        return {"k": k[:, -size:][:, order], "v": v[:, -size:][:, order], "slot_pos": kept[order]}
    pad = max(max_len or S, S) - S
    if not pad:  # (a DTensor's pad by nothing fails on some torch versions)
        return {"k": k, "v": v, "slot_pos": torch.arange(S, dtype=torch.int32, device=dev)}
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
            "slot_pos": torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                                   torch.full((pad,), -1, dtype=torch.int32, device=dev)])}


def make_prefill_step(cfg, max_len=None):
    """Full-sequence forward that also materializes the decode caches.

    max_len: if given, full-attention caches are padded to this many slots
    so decode can continue past the prompt (slot j holds position j)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        p1 = T.one_node(params)
        memory = _memory_from_batch(p1, cfg, batch)
        x = T.embed(p1, cfg, tokens.unsqueeze(0))
        positions = T._positions(B, S, tokens.device, like=x)
        cross = T._cross(cfg, positions, memory)
        caches = [[] for _ in cfg.pattern]
        for r in range(cfg.repeats):
            for p_idx, stacked in enumerate(p1["blocks"]):
                blk = tree_map(lambda v: v[:, r], stacked)
                mixer = T._mixer(blk, cfg, p_idx, positions, memory, return_cache=True)
                x, _, state = T._block(blk, cfg, x, mixer, cross)
                x = T.shard_activation(x)
                caches[p_idx].append(_prefill_cache(cfg, cfg.layer_kind(p_idx), state, S, max_len))
        x = T.rms_norm(x, p1["final_norm"], cfg.norm_eps)
        return T.head_logits(p1, cfg, x[:, :, -1])[0], [T.stack_repeats(c) for c in caches]

    return prefill_step


def make_serve_step(cfg):
    def serve_step(params, token, pos, caches, memory=None):
        return T.decode_step(params, cfg, token, caches, pos, memory=memory)

    return serve_step
