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

On DTensors (the dry run's sharded step) `_moe_sharded` dispatches on
shards: with the reference's one global capacity, or with dispatch groups
that follow the data shards.
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
    """`moe_apply` on DTensors (the dry run's sharded step).  x (m, B, S, D)
    is sharded on its batch over the data axes where they divide it, the
    experts' d_ff over "model".

    With dispatch groups aligned to the data shards (``moe_local``), each
    device dispatches its own tokens, its share of the groups, on its
    shards (`_moe_sharded_grouped`).  Otherwise the dispatch is the
    reference's global one (G = 1: one capacity C for the node's B S
    tokens, `_moe_sharded_global`).  Either way the load-balance loss is
    formed from the global means of the router's probabilities and of its
    choices, as the reference's."""
    _, B, S, _ = x.shape
    G = _DISPATCH_GROUPS
    if not (G > 1 and (B * S) % G == 0 and B * S >= 2 * G):
        return _moe_sharded_global(p, cfg, x, capacity_factor)
    n_data = math.prod(x.device_mesh.size(i) for i in _layout(x)[0])
    if B % n_data == 0 and G % n_data == 0:
        return _moe_sharded_grouped(p, cfg, x, capacity_factor, G // n_data, True)
    # groups that do not follow the data shards: every device dispatches them all
    return _moe_sharded_grouped(p, cfg, x, capacity_factor, G, False)


def _layout(x, batch: bool | None = None):
    """The mesh's data dimensions, whether x's batch (dimension 1) is
    sharded over them (``batch``; by default where they divide it), and
    ``place(on_data, on_model)``: the placements with ``on_data`` on the
    data dimensions and ``on_model`` on "model"."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]
    if batch is None:
        batch = x.shape[1] % math.prod(mesh.size(i) for i in data) == 0

    def place(on_data, on_model):
        return [on_data if i in data else on_model if n == "model" else Replicate()
                for i, n in enumerate(mesh.mesh_dim_names)]

    return data, batch, place


def _aux_from_sums(cfg, probs_sum, picks_sum, T: int, scale: float):
    """The load-balance loss E sum_e f_e p_e (times ``scale``) from the sums
    over the node's T tokens of the router's probabilities and of its
    top-k choices (m, E)."""
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    me = probs_sum / T
    ce = picks_sum / (T * topk)
    return E * torch.sum(me * ce, dim=-1) * scale


def _route_sharded(p: dict, cfg, x, groups: int, place, batch: bool):
    """The router on each device's tokens (split into ``groups`` groups):
    the top-k choices and gates (m, groups, Tl, topk), sharded as the
    tokens, and the sums of the probabilities and of the choices over the
    tokens (m, E), Partial sums over the data axes where the batch is
    sharded.  Replicated over "model"; the router's gradient a Partial sum
    over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    E = cfg.num_experts
    tokens = Shard(1) if batch else Replicate()

    def local(x_, router):
        m, Bl, S, D = x_.shape
        probs, idx, gates = _route({"router": router}, cfg, x_.reshape(m, groups, (Bl * S) // groups, D))
        picks = torch.sum(_one_hot(idx, E).to(torch.float32), dim=(1, 2, 3))
        return idx, gates, torch.sum(probs, dim=(1, 2)), picks

    sums = place(Partial() if batch else Replicate(), Replicate())
    rows = place(tokens, Replicate())
    return local_map(local, out_placements=(rows, rows, sums, sums),
                     in_placements=(place(tokens, Replicate()), place(Replicate(), Replicate())),
                     in_grad_placements=(place(tokens, Replicate()), sums),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, p["router"])


def _moe_sharded_grouped(p: dict, cfg, x, capacity_factor: float, groups: int, batch: bool):
    """Shard-local dispatch: each device's tokens (its batch shard with
    ``batch``, else all of them) split into ``groups`` groups with their
    own capacity (`_dispatch`), the experts' d_ff shard over "model"
    (d_model gathered); the output a Partial sum over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    _, batch, place = _layout(x, batch)
    ffn = cfg.d_ff % dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) == 0
    tokens = Shard(1) if batch else Replicate()
    idx, gates, probs_sum, picks_sum = _route_sharded(p, cfg, x, groups, place, batch)
    part = Partial() if ffn else Replicate()
    per_data = Partial() if batch else Replicate()

    def local(x_, wi, wg, wo, idx_, gates_):
        m, Bl, S, D = x_.shape
        xg = x_.reshape(m, groups, (Bl * S) // groups, D)
        out = _dispatch({"wi": wi, "wg": wg, "wo": wo}, cfg, xg, idx_, gates_, capacity_factor)
        return out.reshape(m, Bl, S, D)

    w_in, w_out = Shard(3) if ffn else Replicate(), Shard(2) if ffn else Replicate()
    out = local_map(local, out_placements=place(tokens, part),
                    in_placements=(place(tokens, Replicate()), place(Replicate(), w_in), place(Replicate(), w_in),
                                   place(Replicate(), w_out), place(tokens, Replicate()), place(tokens, Replicate())),
                    in_grad_placements=(place(tokens, part), place(per_data, w_in), place(per_data, w_in),
                                        place(per_data, w_out), place(tokens, Replicate()), place(tokens, part)),
                    device_mesh=mesh, redistribute_inputs=True)(x, p["wi"], p["wg"], p["wo"], idx, gates)
    return out, _aux_from_sums(cfg, probs_sum, picks_sum, x.shape[1] * x.shape[2], cfg.num_experts_per_tok)


def _moe_sharded_global(p: dict, cfg, x, capacity_factor: float):
    """The reference's global dispatch (one capacity C for the node's T = B
    S tokens) on shards:

    1. each device routes its tokens and places each slot at its GLOBAL
       position in its expert: its own exclusive cumulative sum plus the
       slots the devices before it gave each expert (`sharded.sum_before`),
       so the kept slots are the reference's;
    2. it writes its kept slots into a zero buffer of the experts' C rows
       each, laid out (C, m E, D) so that the capacity is its outer
       dimension: the buffer is a Partial sum over the data axes, reduced
       onto the capacity's shards where the data axes divide C, else onto
       d_model's (a decode step's few tokens: C = 40 on 16);
    3. the experts' products on the buffer's shards, d_ff over "model"
       (`sharded.einsum`);
    4. their output, a Partial sum over "model", is gathered over the data
       axes (on its outer dimension: no copy to reorder it), and each
       device combines its own slots.

    The output is a Partial sum over "model", sharded as x on its batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.sharded import einsum, sum_before

    mesh = x.device_mesh
    m, B, S, D = x.shape
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    N, T = m * E, B * S
    C = max(8, int(T * topk / E * capacity_factor))
    data, batch, place = _layout(x)
    n_data = math.prod(mesh.size(i) for i in data)
    ffn = cfg.d_ff % dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) == 0
    tokens = Shard(1) if batch else Replicate()
    over = [i for i in data if mesh.size(i) > 1] if batch else []

    def dispatch(x_, router):
        m_, Bl, S_, D_ = x_.shape
        Tl = Bl * S_
        xt = x_.reshape(m_, Tl, D_)
        probs, idx, gates = _route({"router": router}, cfg, xt)
        flat_e = idx.reshape(m_, Tl * topk)  # token-major slots
        onehot = _one_hot(flat_e, E).to(torch.int64)  # (m, S2, E)
        before = sum_before(torch.sum(onehot, dim=1), mesh, over)  # (m, E): the earlier shards' slots
        pos = torch.sum((torch.cumsum(onehot, dim=1) - onehot + before[:, None]) * onehot, dim=-1)
        keep = pos < C
        node = torch.arange(m_, device=x_.device).reshape(m_, 1)
        rows = torch.where(keep, pos * N + node * E + flat_e, C * N)  # dropped slots: a spare row
        slots = xt[:, :, None, :].expand(m_, Tl, topk, D_).reshape(-1, D_)
        buf = torch.zeros((C * N + 1, D_), dtype=x_.dtype, device=x_.device).index_put((rows.reshape(-1),), slots)
        picks = torch.sum(onehot.to(torch.float32), dim=1)
        return buf[:C * N].reshape(C, N, D_), rows, gates, torch.sum(probs, dim=1), picks

    sums = place(Partial() if batch else Replicate(), Replicate())
    buf, rows, gates, probs_sum, picks_sum = local_map(
        dispatch, out_placements=(sums, place(tokens, Replicate()), place(tokens, Replicate()), sums, sums),
        in_placements=(place(tokens, Replicate()), place(Replicate(), Replicate())),
        in_grad_placements=(place(tokens, Replicate()), sums),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])
    # the buffer reduced onto its shards: the capacity's, else d_model's
    on = Shard(0) if C % n_data == 0 else Shard(2) if D % n_data == 0 else Replicate()
    a = buf.redistribute(mesh, place(on, Replicate()))
    del buf
    wg, wi, wo = (p[k].reshape(N, *p[k].shape[2:]) for k in ("wg", "wi", "wo"))
    h = _silu(einsum("cnd,ndf->cnf", a, wg)) * einsum("cnd,ndf->cnf", a, wi)
    del a
    y = einsum("cnf,nfd->cnd", h, wo)
    del h
    part = Partial() if ffn else Replicate()
    y = y.redistribute(mesh, place(Replicate(), part))

    def combine(y_, rows_, gates_):
        m_, Tl, _ = gates_.shape
        kept = rows_ < C * N
        gathered = y_.reshape(C * N, D)[torch.where(kept, rows_, 0).reshape(-1)].reshape(m_, Tl, topk, D)
        gathered = torch.where(kept.reshape(m_, Tl, topk)[..., None], gathered, 0.0)  # a dropped slot reads zeros
        out = torch.sum(gathered * gates_.to(gathered.dtype)[..., None], dim=2)
        return out.reshape(m_, Tl // S, S, D)

    out = local_map(combine, out_placements=place(tokens, part),
                    in_placements=(place(Replicate(), part), place(tokens, Replicate()), place(tokens, Replicate())),
                    in_grad_placements=(place(Partial() if batch else Replicate(), Replicate()),
                                        place(tokens, Replicate()), place(tokens, part)),
                    device_mesh=mesh, redistribute_inputs=True)(y, rows, gates)
    return out, _aux_from_sums(cfg, probs_sum, picks_sum, T, 1.0)
