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

On DTensors (the dry run's sharded step) train and prefill attention run
on each device's shards after the projections (`_attn_sharded`): split
by heads where the model axis divides them, else by queries, so no score,
mask or repeated key exists beyond a device's share; decode writes the
new key and value into a cache sharded on its slots by an elementwise
``where`` (`_write_slot`), takes the softmax on the slots' shards
(`repro_torch.models.sharded.softmax`) and, where a batch of one leaves
the data axes idle, splits the value product's heads over them
(`_values_on_idle_data`).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, bias_init, dense_init, init_device, linear, softcap
from repro_torch.models.sharded import einsum, is_dtensor, shard_index, softmax, split_dim
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


def _project(p, x, memory=None):
    """x (m, B, S, D) -> q (m, B, S, H*hd), k and v (m, B, Sk, KV*hd), the
    heads not yet split."""
    q = linear(x, p["wq"])
    kv_src = memory if memory is not None else x
    k = linear(kv_src, p["wk"])
    v = linear(kv_src, p["wv"])
    if "bq" in p:
        q = q + p["bq"][:, None, None]
        k = k + p["bk"][:, None, None]
        v = v + p["bv"][:, None, None]
    return q, k, v


def _project_qkv(p, cfg, x, positions, memory=None, rope=True):
    """x (m, B, S, D) -> q (m, B, S, H, hd), k and v (m, B, Sk, KV, hd)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project(p, x, memory)
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


def _query_chunks(q, qpos, k, v, kpos, cfg, kind, q_chunk):
    """The attention of q (m, B, Sq, H, hd) over k and v, ``q_chunk``
    queries at a time, each chunk recomputed in the backward pass ->
    (m, B, Sq, H*hd)."""
    S = q.shape[2]
    q_chunk = min(q_chunk, S)
    assert S % q_chunk == 0, (S, q_chunk)
    outs = []
    for c in range(max(1, S // q_chunk)):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        (out,) = checkpoint(_chunk_attn, q[:, :, sl], qpos[:, sl], k, v, kpos, cfg, kind)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attn_apply(p, cfg, x, positions, kind="full", memory=None, q_chunk=1024):
    """Training / prefill attention.  Returns (out, (k, v)); k and v feed
    caches.

    kind: "full" causal, "swa" causal window, "cross" (no mask, kv from
    ``memory``), "bidir" (encoder, no mask)."""
    if is_dtensor(x):
        return _attn_sharded(p, cfg, x, positions, kind, memory, q_chunk)
    q, k, v = _project_qkv(
        p, cfg, x, positions, memory=memory if kind == "cross" else None, rope=kind != "cross",
    )
    kpos = positions if kind != "cross" else None
    out = _query_chunks(q, positions, k, v, kpos, cfg, kind, q_chunk)
    return linear(out, p["wo"]), (k, v)


def _attn_sharded(p, cfg, x, positions, kind, memory, q_chunk):
    """`attn_apply` on DTensors (the dry run's sharded step): the
    projections as DTensor products, then the heads' split, RoPE, the masks
    and the chunked attention on each device's shards (``local_map``), so
    no score, mask or repeated key exists beyond this device's share.

    Over the mesh axes that do not shard the batch (the model axis), the
    attention is split by heads where they divide (q's heads as the
    projection shards them; k and v by KV heads where those divide too,
    else gathered and each local query head's KV head taken on the
    shard), and otherwise by queries (28 heads on 16: q resharded from its
    columns to its sequence, k and v gathered; each device's chunk of
    q_chunk / n queries holds the scores of q_chunk heads' worth; the
    output resharded back to q's columns for ``wo``).  The
    positions are ``positions``' shards (a DTensor sharded as the batch,
    `repro_torch.models.sharded.batch_positions`).  Returns (out, (k, v))
    as `attn_apply`, k and v roped, split into heads."""
    import math

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    q, k, v = _project(p, x, memory if kind == "cross" else None)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh, S = q.device_mesh, q.shape[2]
    if not is_dtensor(positions):
        positions = DTensor.from_local(positions, mesh, [Replicate()] * mesh.ndim, run_check=False)
    batch = [isinstance(pl, Shard) and pl.dim == 1 for pl in q.placements]
    split = [i for i in range(mesh.ndim) if not batch[i] and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in split)
    by_heads = H % n == 0 and all(q.placements[i] == Shard(3) for i in split)
    if not by_heads and S % n:
        split, n = [], 1  # neither divides: every device of those axes computes the whole
    kv_split = by_heads and KV % n == 0
    chunk = q_chunk if by_heads else math.gcd(S // n, max(1, q_chunk // n))
    kv_index = None
    if by_heads and not kv_split:
        first = shard_index(mesh, split)[0] * (H // n)
        kv_index = [h // (H // KV) for h in range(first, first + H // n)]
    rope = kind != "cross" and cfg.use_rope

    def pl(dim, part):
        return [Shard(dim) if batch[i] else part if i in split else Replicate() for i in range(mesh.ndim)]

    q_pl = pl(1, Shard(3) if by_heads else Shard(2))
    kv_pl, kv_grad = (pl(1, Shard(3)), pl(1, Shard(3))) if kv_split else (pl(1, Replicate()), pl(1, Partial()))
    qpos_pl, kpos_pl = pl(0, Replicate() if by_heads else Shard(1)), pl(0, Replicate())

    def local(ql, kl, vl, qpos, kpos):
        ql = ql.reshape(*ql.shape[:3], -1, hd)
        kl, vl = kl.reshape(*kl.shape[:3], -1, hd), vl.reshape(*vl.shape[:3], -1, hd)
        if rope:
            ql, kl = apply_rope(ql, qpos, cfg.rope_theta), apply_rope(kl, kpos, cfg.rope_theta)
        kr, vr = kl, vl
        if kv_index is not None:
            idx = torch.tensor(kv_index, device=kl.device)
            kr, vr = kl[:, :, :, idx], vl[:, :, :, idx]
        out = _query_chunks(ql, qpos, kr, vr, kpos if kind != "cross" else None, cfg, kind, chunk)
        return out, kl, vl

    out, k, v = local_map(local, out_placements=(q_pl, kv_pl, kv_pl),
                          in_placements=(q_pl, kv_pl, kv_pl, qpos_pl, kpos_pl),
                          in_grad_placements=(q_pl, kv_grad, kv_grad, qpos_pl, kpos_pl),
                          device_mesh=mesh, redistribute_inputs=True)(q, k, v, positions, positions)
    if split and not by_heads:  # back to q's columns: a product cannot flatten a sequence-sharded batch
        out = out.redistribute(mesh, pl(1, Shard(3)))
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


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """A copy of ``cache`` (m, B, size, KV, hd) with ``new`` (m, B, 1, KV,
    hd) in slot ``slot``.  A DTensor cache (sharded on its slots) is
    written elementwise, a ``where`` against the slot's index, so it stays
    on its shards: an assignment by index gathers it."""
    if not is_dtensor(cache):
        out = cache.clone()
        out[:, :, slot] = new[:, :, 0]
        return out
    from torch.distributed.tensor import Replicate

    new = new.redistribute(new.device_mesh, [Replicate()] * new.device_mesh.ndim)  # one token: it follows the cache
    at = torch.arange(cache.shape[2], device=new.device).reshape(1, 1, -1, 1, 1) == slot
    return torch.where(at, new, cache)


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
    k_cache, v_cache, slot_pos = _write_slot(cache["k"], k_new, slot), _write_slot(cache["v"], v_new, slot), \
        cache["slot_pos"].clone()
    slot_pos[slot] = pos

    scores = _gqa_scores(q, k_cache, cfg)  # (m, B, KV, G, 1, size)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if kind == "swa" and cfg.window:
        valid = valid & (slot_pos > (pos - cfg.window))
    scores = torch.where(valid, scores, NEG_INF)
    probs = softmax(scores, -1).to(v_cache.dtype)
    out = _values_on_idle_data(probs, v_cache) if is_dtensor(probs) else None
    if out is None:
        out = _gqa_out(probs, v_cache)
    return linear(out, p["wo"]), {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}


def _values_on_idle_data(probs, v):
    """A decode step's value product, probs (m, B, KV, G, 1, S) and v (m,
    B, S, KV, hd) DTensors, where the batch leaves the data axes idle (B
    = 1): the query heads split over the data axes on each device's shards
    (its heads' KV heads taken from v), as the reference's compiled step
    splits this product (and not the scores).  The output (m, B, 1, H hd)
    is sharded on its heads over the data axes, a Partial sum where the
    slots are sharded.  None where the data axes shard the batch or do not
    divide the query heads."""
    import math

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = probs.device_mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data") and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in data)
    m, B, KV, G, _, S = probs.shape
    H, hd = KV * G, v.shape[-1]
    if not data or any(isinstance(probs.placements[i], Shard) for i in data) or H % n or (H // n) % G and G % (H // n):
        return None
    hq = H // n
    slots = [i for i, pl in enumerate(v.placements) if isinstance(pl, Shard) and pl.dim == 2]
    p_pl = [Shard(5) if i in slots else Replicate() for i in range(mesh.ndim)]
    v_pl = [Shard(2) if i in slots else Replicate() for i in range(mesh.ndim)]
    out_pl = [Shard(3) if i in data else Partial() if i in slots else Replicate() for i in range(mesh.ndim)]

    def local(pr, vl):
        h0 = shard_index(mesh, data)[0] * hq
        k0, k1 = h0 // G, (h0 + hq - 1) // G + 1
        sel = pr.reshape(m, B, H, 1, pr.shape[-1])[:, :, h0:h0 + hq].reshape(m, B, k1 - k0, hq // (k1 - k0), 1, -1)
        out = einsum("nbkgqs,nbskh->nbqkgh", sel, vl[:, :, :, k0:k1])
        return out.reshape(m, B, 1, hq * hd)

    return local_map(local, out_placements=out_pl, in_placements=(p_pl, v_pl), device_mesh=mesh,
                     redistribute_inputs=True)(probs, v)
