"""GQA attention: causal / sliding-window / cross / bidirectional, train,
prefill and decode (``repro.models.attention``'s counterpart).

Node-stacked as `repro_torch.models.layers`: parameters, activations and
caches carry a leading node axis ``m``; positions are (B, S), the same for
every node.

Ported op by op, in the reference's dtypes:

* the scores are a product in the activations' dtype (bf16 in, bf16 out,
  as ``jnp.einsum`` of bf16 gives), cast to f32 and divided by
  sqrt(head_dim), then soft-capped (Gemma 2's ``attn_softcap``);
* masked positions take ``NEG_INF`` = -2e38; the softmax runs in f32 and
  is cast to v's dtype before the second product.

No fused attention kernel (``scaled_dot_product_attention``,
``flex_attention``) stands in for it: neither has the logit soft-cap, and
either would change the products that ``compute_flops`` counts.

Prefill and train attention loop over QUERY CHUNKS (``q_chunk``) so the
score tensor never exceeds (m, B, H, q_chunk, S); each chunk's scores are
recomputed in the backward pass (`repro_torch.models.remat.checkpoint`),
as the reference's ``jax.checkpoint`` does.  Decode reads a KV cache
(m, B, S_max, KV, hd); a sliding-window cache is a ring buffer of the
window's size, RoPE applied at insertion with absolute positions, each
slot's absolute position kept in ``slot_pos``.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, bias_init, dense_init, init_device, linear, softcap
from repro_torch.models.sharded import einsum, sharded_evenly, split_dim
from repro_torch.models.remat import checkpoint

NEG_INF = -2.0e38


def attn_init(generator, cfg, kind: str) -> tuple[dict, dict]:
    """One attention layer's weights (wq, wk, wv, wo, drawn in that order),
    plus zero q/k/v biases when ``cfg.qkv_bias``, and their axes."""
    d, dt = cfg.d_model, cfg.dtype
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wq, sq = dense_init(generator, d, H * hd, "embed", "heads_hd", dt)
    wk, sk = dense_init(generator, d, KV * hd, "embed", "kv_hd", dt)
    wv, sv = dense_init(generator, d, KV * hd, "embed", "kv_hd", dt)
    wo, so = dense_init(generator, H * hd, d, "heads_hd", "embed", dt)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    s = {"wq": sq, "wk": sk, "wv": sv, "wo": so}
    if cfg.qkv_bias:
        dev = init_device(generator)
        p["bq"], s["bq"] = bias_init(H * hd, "heads_hd", dt, dev)
        p["bk"], s["bk"] = bias_init(KV * hd, "kv_hd", dt, dev)
        p["bv"], s["bv"] = bias_init(KV * hd, "kv_hd", dt, dev)
    return p, s


def _project_qkv(p, cfg, x, positions, memory=None, rope=True):
    """x (m, B, S, D) -> q (m, B, S, H, hd), k and v (m, B, Sk, KV, hd)."""
    m, B = x.shape[0], x.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"])
    kv_src = memory if memory is not None else x
    k = linear(kv_src, p["wk"])
    v = linear(kv_src, p["wv"])
    if "bq" in p:
        q = q + p["bq"][:, None, None]
        k = k + p["bk"][:, None, None]
        v = v + p["bv"][:, None, None]
    q, k, v = split_dim(q, -1, H, hd), split_dim(k, -1, KV, hd), split_dim(v, -1, KV, hd)
    if rope and cfg.use_rope and memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """q: (m, B, Sq, H, hd), k: (m, B, Sk, KV, hd) -> (m, B, KV, H//KV, Sq, Sk), f32."""
    m, B, Sq, H, hd = q.shape
    KV = k.shape[3]
    qg = split_dim(q, 3, KV, H // KV)
    scores = einsum("nbqkgh,nbskh->nbkgqs", qg, k).to(torch.float32)
    # a tensor made by an operator, not a constant: the oracle graphs share
    # what reads x alone by expression, and a constant is a new one in each
    # trace (and a divisor, as XLA divides, where a Python number multiplies
    # by its reciprocal on the card)
    scores = scores / torch.sqrt(torch.full((), float(hd), dtype=torch.float32, device=scores.device))
    return softcap(scores, cfg.attn_softcap)


def _gqa_out(probs, v):
    """probs: (m, B, KV, G, Sq, Sk), v: (m, B, Sk, KV, hd) -> (m, B, Sq, H*hd)."""
    out = einsum("nbkgqs,nbskh->nbqkgh", probs, v)
    return out.reshape(out.shape[0], out.shape[1], out.shape[2], -1)


def _kv_for_heads(q, k, v):
    """k and v for the products with q: as they are, or, where q's heads
    are sharded over a mesh axis that does not divide the KV heads (a
    DTensor of the dry run: 8 KV heads on a model axis of 16), each KV head
    repeated for its H / KV query heads, so the products group nothing
    and q keeps its sharding.  A plain tensor is never repeated."""
    H, KV = q.shape[3], k.shape[3]
    if KV == H or sharded_evenly(q, 3, KV):
        return k, v

    def rep(t):
        m, B, S, _, hd = t.shape
        return t[:, :, :, :, None, :].expand(m, B, S, KV, H // KV, hd).reshape(m, B, S, H, hd)

    return rep(k), rep(v)


def _chunk_attn(q_c, qpos_c, k, v, kpos, cfg, kind):
    """One query chunk: scores, mask, softmax and the weighted values."""
    scores = _gqa_scores(q_c, k, cfg)  # (m, B, KV, G, qc, Sk)
    if kind in ("full", "swa"):
        mask = qpos_c[:, :, None] >= kpos[:, None, :]  # causal (B, qc, Sk)
        if kind == "swa" and cfg.window:
            mask = mask & ((qpos_c[:, :, None] - kpos[:, None, :]) < cfg.window)  # not in place: traced
        scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_out(probs, v)


def attn_apply(p, cfg, x, positions, kind="full", memory=None, q_chunk=1024):
    """Training / prefill attention.  Returns (out, (k, v)); k and v feed
    caches.

    kind: "full" causal, "swa" causal window, "cross" (no mask, kv from
    ``memory``), "bidir" (encoder, no mask)."""
    S = x.shape[2]
    q, k, v = _project_qkv(
        p, cfg, x, positions, memory=memory if kind == "cross" else None, rope=kind != "cross",
    )
    kpos = positions if kind != "cross" else None
    q_chunk = min(q_chunk, S)
    assert S % q_chunk == 0, (S, q_chunk)
    kr, vr = _kv_for_heads(q, k, v)
    outs = []
    for c in range(max(1, S // q_chunk)):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        (out,) = checkpoint(_chunk_attn, q[:, :, sl], positions[:, sl], kr, vr, kpos, cfg, kind)
        outs.append(out)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return linear(out, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def make_cache(cfg, m: int, batch: int, s_max: int, kind="full", dtype=None, device=None) -> dict:
    """One attention layer's cache, node-stacked (callers stack over layers)."""
    dt = dtype or cfg.dtype
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    size = cfg.window if (kind == "swa" and cfg.window) else s_max
    size = min(size, s_max)
    return {
        "k": torch.zeros((m, batch, size, KV, hd), dtype=dt, device=device),
        "v": torch.zeros((m, batch, size, KV, hd), dtype=dt, device=device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def cache_specs(kind: str) -> dict:
    """The cache tree's logical axes, as the reference names them (the node
    axis in front is not one of them)."""
    return {
        "k": ("batch", "cache_seq", None, None),
        "v": ("batch", "cache_seq", None, None),
        "slot_pos": (None,),
    }


def attn_decode(p, cfg, x_t, cache, pos: int, kind="full", memory=None):
    """One-token decode.  x_t: (m, B, 1, D); pos: the absolute position.
    Returns (out (m, B, 1, D), new_cache); the cache given is not changed."""
    B = x_t.shape[1]
    if kind == "cross":  # the memory is fixed: no cache update
        q, k, v = _project_qkv(p, cfg, x_t, None, memory=memory, rope=False)
        probs = torch.softmax(_gqa_scores(q, k, cfg), dim=-1).to(v.dtype)
        return linear(_gqa_out(probs, v), p["wo"]), cache

    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k_new, v_new = _project_qkv(p, cfg, x_t, posv)
    size = cache["k"].shape[2]
    # a full cache has size s_max > pos, so slot = pos; a window's ring cycles
    slot = pos % size
    k_cache, v_cache, slot_pos = cache["k"].clone(), cache["v"].clone(), cache["slot_pos"].clone()
    k_cache[:, :, slot] = k_new[:, :, 0]
    v_cache[:, :, slot] = v_new[:, :, 0]
    slot_pos[slot] = pos

    scores = _gqa_scores(q, k_cache, cfg)  # (m, B, KV, G, 1, size)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if kind == "swa" and cfg.window:
        valid = valid & (slot_pos > (pos - cfg.window))
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = _gqa_out(probs, v_cache)
    return linear(out, p["wo"]), {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}
