"""Top-k mixture of experts with capacity-based dispatch, Mixtral / Jamba
style (``repro.models.moe``'s counterpart).

Node-stacked as `repro_torch.models.layers`: every parameter and
activation carries a leading node axis ``m``, and each node dispatches
its own tokens (the reference vmaps a node's loss): the capacity
C = max(8, int(T topk / E * capacity_factor)) counts one node's T = B S
tokens (one group's, with dispatch groups), never the m nodes' together.

The reference's sort-free dispatch, step by step:

1. the router's logits, a product in the activations' dtype cast to f32;
   its softmax; the top-k experts of each token, ties to the lower expert
   index (``jax.lax.top_k``'s order: a stable descending sort here, since
   ``torch.topk`` promises no order among equal values), and their gates
   renormalized;
2. each token-slot's position in its expert (the exclusive cumulative sum
   over the slots, token-major); a slot at position C or beyond is dropped;
3. the tokens written into an (E, C, D) buffer;
4. the experts' SwiGLU as three batched products over E;
5. each slot's expert output, weighted by its gate, summed over the token's
   slots.

Determinism on the card: kept slots have distinct (expert, position)
rows, so the buffer is written by one ``index_put`` without accumulation,
and the dropped slots (the reference adds +0.0 into row C - 1) write into
one spare row that is then cut off; the combine reads that spare row as
zeros and sums a token's ``topk`` slots in slot order with ``sum`` over
the slot axis, which for top-2 (every config) is the reference's 0 + a +
b exactly.  No atomics decide a kept value, so two runs give the same
bits.

The load-balance loss (Switch style): E sum_e f_e p_e, and with dispatch
groups (G > 1) the reference's grouped form, scaled by topk.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import _silu, dense_init, linear, normal, shard_activation
from repro_torch.models.sharded import is_dtensor

# Dispatch groups, as the reference sets them: with G > 1 each node's
# tokens split into G groups with their own capacity (shard-local dispatch
# on a TPU mesh); G = 1 is one global capacity a node.
_DISPATCH_GROUPS = 1


def set_moe_dispatch_groups(groups: int) -> None:
    global _DISPATCH_GROUPS
    _DISPATCH_GROUPS = max(1, int(groups))


def moe_init(generator, cfg) -> tuple[dict, dict]:
    """The experts' stacked SwiGLU weights wi, wg (E, d, f) and wo (E, f, d)
    (normals over sqrt(in_dim), in that order), then the f32 router (d, E),
    a normal times 0.02; and their axes (the experts' d_model is its own
    axis, ``moe_embed``, so a sharding variant can treat it apart)."""
    d, f, dt, E = cfg.d_model, cfg.d_ff, cfg.dtype, cfg.num_experts

    def expert_stack(in_dim, out_dim, in_ax, out_ax):
        return (normal(generator, (E, in_dim, out_dim)) / math.sqrt(in_dim)).to(dt), ("experts", in_ax, out_ax)

    wi, si = expert_stack(d, f, "moe_embed", "ffn")
    wg, sg = expert_stack(d, f, "moe_embed", "ffn")
    wo, so = expert_stack(f, d, "ffn", "moe_embed")
    router, sr = dense_init(generator, d, E, "embed", None, torch.float32, scale=0.02)
    return {"wi": wi, "wg": wg, "wo": wo, "router": router}, {"wi": si, "wg": sg, "wo": so, "router": sr}


def moe_apply(p: dict, cfg, x: torch.Tensor, capacity_factor: float = 1.25):
    """x (m, B, S, D) -> (out (m, B, S, D), aux (m,))."""
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x, capacity_factor)
    m, B, S, D = x.shape
    G = _DISPATCH_GROUPS
    if G > 1 and (B * S) % G == 0 and B * S >= 2 * G:
        out, aux = _moe_tokens_grouped(p, cfg, x.reshape(m, G, (B * S) // G, D), capacity_factor)
    else:
        out, aux = _moe_tokens(p, cfg, x.reshape(m, B * S, D), capacity_factor)
    return out.reshape(m, B, S, D), aux


def _route(p: dict, cfg, xt: torch.Tensor):
    """xt (m, ..., D) -> probs (m, ..., E) f32, the top-k expert indices
    (lower index first among ties) and their renormalized gates."""
    logits = linear(xt, p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :cfg.num_experts_per_tok]
    gates = torch.gather(probs, -1, idx)
    return probs, idx, gates / torch.sum(gates, dim=-1, keepdim=True)


def _one_hot(idx: torch.Tensor, E: int) -> torch.Tensor:
    return idx[..., None] == torch.arange(E, device=idx.device)


def _shard_buffer(t: torch.Tensor, m: int, G: int) -> torch.Tensor:
    """`shard_activation` of the grouped dispatch buffer, whose rows (m * E,
    G * C, D) run (node, expert, group, position): constrained as the
    reference's (G, E, C, D) buffer, the groups in dimension 1 behind the
    node axis.  Ungrouped (G = 1) or with no constraint set, ``t`` as it
    is, as the reference constrains only its grouped buffer."""
    if G == 1 or L._ACT_CONSTRAINT is None:
        return t
    mE, GC, D = t.shape
    g = shard_activation(t.reshape(m, mE // m, G, GC // G, D).transpose(1, 2))
    return g.transpose(1, 2).reshape(mE, GC, D)


def _dispatch(p: dict, cfg, xg: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, capacity_factor: float):
    """xg (m, G, Tl, D), idx and gates (m, G, Tl, topk) -> out (m, G, Tl, D):
    each group of each node dispatched on its own, with capacity
    max(8, int(Tl topk / E capacity_factor))."""
    m, G, Tl, D = xg.shape
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    C = max(8, int(Tl * topk / E * capacity_factor))
    flat_e = idx.reshape(m, G, Tl * topk)  # token-major slots
    onehot = _one_hot(flat_e, E).to(torch.int64)  # (m, G, S2, E)
    pos = torch.sum((torch.cumsum(onehot, dim=2) - onehot) * onehot, dim=-1)  # exclusive, (m, G, S2)
    keep = pos < C
    # the buffer's rows, (node, expert, group, position), so each node's
    # experts are one batch of G * C rows; dropped slots go to a spare row
    node = torch.arange(m, device=xg.device).reshape(m, 1, 1)
    grp = torch.arange(G, device=xg.device).reshape(1, G, 1)
    spare = m * E * G * C
    rows = torch.where(keep, ((node * E + flat_e) * G + grp) * C + pos, spare).reshape(-1)
    slots = xg[:, :, :, None, :].expand(m, G, Tl, topk, D).reshape(-1, D)
    buf = torch.zeros((spare + 1, D), dtype=xg.dtype, device=xg.device).index_put((rows,), slots)
    a = _shard_buffer(buf[:spare].reshape(m * E, G * C, D), m, G)
    wg, wi, wo = (p[k].reshape(m * E, *p[k].shape[2:]) for k in ("wg", "wi", "wo"))
    h = _silu(torch.bmm(a, wg)) * torch.bmm(a, wi)
    y = _shard_buffer(torch.bmm(h, wo), m, G).reshape(spare, D)
    y = torch.cat([y, torch.zeros((1, D), dtype=y.dtype, device=y.device)])  # the spare row reads zeros
    gathered = y[rows].reshape(m, G, Tl, topk, D)
    return torch.sum(gathered * gates.to(gathered.dtype)[..., None], dim=3)


def _moe_tokens(p: dict, cfg, xt: torch.Tensor, capacity_factor: float = 1.25):
    """xt (m, T, D) -> (out (m, T, D), aux (m,)): one dispatch a node."""
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    probs, idx, gates = _route(p, cfg, xt)
    me = torch.mean(probs, dim=1)  # (m, E)
    ce = torch.mean(torch.sum(_one_hot(idx, E).to(torch.float32), dim=2), dim=1) / topk
    aux = E * torch.sum(me * ce, dim=-1)
    out = _dispatch(p, cfg, xt[:, None], idx[:, None], gates[:, None], capacity_factor)
    return out[:, 0], aux


def _moe_tokens_grouped(p: dict, cfg, xg: torch.Tensor, capacity_factor: float):
    """xg (m, G, Tl, D) -> (out (m, G, Tl, D), aux (m,)): G dispatches a
    node, each with its own capacity; the reference's grouped aux scaling."""
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    xg = shard_activation(xg)
    probs, idx, gates = _route(p, cfg, xg)
    me = torch.mean(probs, dim=(1, 2))
    ce = torch.mean(_one_hot(idx, E).to(torch.float32), dim=(1, 2, 3))
    aux = E * torch.sum(me * ce, dim=-1) * topk  # matches the ungrouped scaling
    return shard_activation(_dispatch(p, cfg, xg, idx, gates, capacity_factor)), aux


def _moe_sharded(p: dict, cfg, x, capacity_factor: float):
    """`moe_apply` on DTensors (the dry run's sharded step), run on each
    device's shards (``local_map``): its batch shard of the tokens, the
    experts' d_ff shard over "model" (d_model gathered, the router
    replicated).  Each device dispatches its own tokens with its own
    capacity (its share of the dispatch groups, or one group), so the
    output is a Partial sum over "model" and the aux loss the mean over
    the data shards.  The reference's ungrouped dispatch keeps one global
    capacity instead; the costs are those of the shard-local dispatch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data = [n for n in mesh.mesh_dim_names if n in ("pod", "data")]
    n_data = math.prod(sizes[n] for n in data)
    batch = x.shape[1] % n_data == 0
    ffn = cfg.d_ff % sizes.get("model", 1) == 0

    def place(shard_data, model):
        return [shard_data if n in data else model if n == "model" else Replicate() for n in mesh.mesh_dim_names]

    x_pl = place(Shard(1) if batch else Replicate(), Replicate())
    w_in = place(Replicate(), Shard(3) if ffn else Replicate())
    w_out = place(Replicate(), Shard(2) if ffn else Replicate())
    rep = place(Replicate(), Replicate())
    out_pl = place(Shard(1) if batch else Replicate(), Partial() if ffn else Replicate())
    aux_pl = place(Partial("avg") if batch else Replicate(), Replicate())
    groups = max(1, _DISPATCH_GROUPS // n_data) if batch else _DISPATCH_GROUPS

    def local(x_, wi, wg, wo, router):
        global _DISPATCH_GROUPS
        saved, _DISPATCH_GROUPS = _DISPATCH_GROUPS, groups
        try:
            return moe_apply({"wi": wi, "wg": wg, "wo": wo, "router": router}, cfg, x_, capacity_factor)
        finally:
            _DISPATCH_GROUPS = saved

    fn = local_map(local, out_placements=(out_pl, aux_pl), in_placements=(x_pl, w_in, w_in, w_out, rep),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p["wi"], p["wg"], p["wo"], p["router"])
