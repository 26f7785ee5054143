"""Mamba-2 (SSD, state-space duality) layer: the chunked train / prefill
scan and the one-token decode recurrence (``repro.models.ssm``'s
counterpart).  [arXiv:2405.21060]

Node-stacked as `repro_torch.models.layers`: parameters, activations,
states and caches carry a leading node axis ``m``.

The chunked algorithm, as the reference computes it: within a chunk of
length Q the output is a masked attention-like product (the dual form);
across chunks an (H, P, N) state is carried, by a loop over the chunks
where the reference scans them.  Decode carries the state and the last
D_CONV - 1 raw conv inputs: state <- exp(A dt) state + dt x (x) B,
y = state . C + D x.

Ported op by op, in the reference's dtypes: ``a_log``, ``d_skip`` and
``dt_bias`` are f32 leaves whatever the model's dtype, dt is computed in
f32, the causal conv sums its D_CONV taps in the input's dtype in tap
order, the scores C B^T are a product in the model's dtype cast to f32,
and the rest of the scan runs in f32.  ``softplus`` is ``torch.logaddexp(x,
0)``, the reference's ``jax.nn.softplus`` (``jnp.logaddexp``: max(x, 0) +
log1p(exp(-|x|)), the same formula); ``F.softplus`` would switch to the
identity above 20 and take log1p(exp(x)) below.

The reference's multi-operand einsums are contracted in this fixed
pairwise order (elementwise products first, then one batched matrix
product), so ``compute_flops`` counts exactly the products named here:

* y_diag "bhqk,bkh,bkhp->bqhp": (x dt) elementwise, then M @ (x dt) over k;
* y_off "bqhn,bhpn,bqh->bqhp": (C decay_in) elementwise, then @ state^T over n;
* new_contrib "bqhn,bqh,bqh,bqhp->bhpn": w = dt decay_out, (B w)
  elementwise, then x^T @ (B w) over q;
* decode "bh,bhp,bhn->bhpn": (B dt) elementwise, then the outer product
  with x (elementwise); y "bhpn,bhn->bhp": state @ C over n.

Groups broadcast onto heads with ``repeat_interleave`` (``jnp.repeat``:
group g serves heads g * H/G to (g + 1) * H/G - 1).

On DTensors (the dry run's sharded step) a layer runs on each device's
heads where the model axis divides them (`_mamba_apply_sharded`,
`_decode_inputs_sharded`), as the reference's compiled step splits it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _silu, dense_init, init_device, linear, normal, rms_norm, uniform
from repro_torch.models.sharded import cumsum, is_dtensor, matmul, pad_front, shard_index

D_CONV = 4  # depthwise causal conv width


def ssm_dims(cfg) -> tuple[int, int]:
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, conv_dim


def mamba_init(generator, cfg) -> tuple[dict, dict]:
    """One Mamba-2 layer's parameters, drawn in this order: w_in, w_out,
    conv_w (a normal over sqrt(D_CONV)), a_log (log of a uniform on [1,
    16]); d_skip ones, dt_bias zeros (both f32), norm ones; and their
    axes."""
    d, dt = cfg.d_model, cfg.dtype
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    d_inner, conv_dim = ssm_dims(cfg)
    dev = init_device(generator)
    in_dim = 2 * d_inner + 2 * G * N + H  # z, x, B, C, dt
    w_in, s_in = dense_init(generator, d, in_dim, "embed", "ssm_in", dt)
    w_out, s_out = dense_init(generator, d_inner, d, "ssm_in", "embed", dt)
    conv_w = (normal(generator, (D_CONV, conv_dim)) / math.sqrt(D_CONV)).to(dt)
    a = uniform(generator, (H,)) * 15.0 + 1.0
    p = {
        "w_in": w_in,
        "w_out": w_out,
        "conv_w": conv_w,
        "a_log": torch.log(a),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": torch.ones((d_inner,), dtype=dt, device=dev),
    }
    s = {"w_in": s_in, "w_out": s_out, "conv_w": (None, "ssm_in"), "a_log": (None,), "d_skip": (None,),
         "dt_bias": (None,), "norm": (None,)}
    return p, s


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + exp(0)) as max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(cfg, proj: torch.Tensor):
    """proj (..., in_dim) -> z (d_inner), xBC (d_inner + 2 G N), dt_raw (H)."""
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner + 2 * gn, cfg.ssm_heads], dim=-1)


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then SiLU.  xBC (m, B, S,
    C), conv_w (m, D_CONV, C); ``conv_state`` (m, B, D_CONV - 1, C), in
    decode, is the left context (else zeros).  The taps are summed in
    xBC's dtype, tap 0 first."""
    if conv_state is not None:
        xfull = torch.cat([conv_state, xBC], dim=2)
    else:
        xfull = pad_front(xBC, 2, D_CONV - 1)
    S = xBC.shape[2]
    out = None
    for i in range(D_CONV):
        tap = xfull[:, :, i:i + S] * conv_w[:, i][:, None, None, :]
        out = tap if out is None else out + tap
    return _silu(out)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < k <= i} a[..., k], -inf
    above the diagonal (so exp gives 0 there, and a finite gradient)."""
    Q = a.shape[-1]
    cs = cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, out, float("-inf"))


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(m, B, S, G, N) -> (m, B, S, H, N): each group serves ``rep``
    consecutive heads (``jnp.repeat``)."""
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=3)


def ssd_chunked(cfg, x, B_mat, C_mat, dt, a_log, init_state=None):
    """The SSD forward.  x (m, B, S, H, P); B_mat and C_mat (m, B, S, G, N);
    dt (m, B, S, H) f32; a_log (m, H).  Returns y (m, B, S, H, P) in x's
    dtype and the final state (m, B, H, P, N) f32."""
    m, Bsz, S, H, P = x.shape
    G, N = B_mat.shape[3], B_mat.shape[4]
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    A = -torch.exp(a_log)  # (m, H), negative
    Bh, Ch = _heads(B_mat, H // G), _heads(C_mat, H // G)
    adt = A[:, None, None, :] * dt  # (m, B, S, H)
    f32 = torch.float32
    state = init_state if init_state is not None else torch.zeros((m, Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x_q, B_q, C_q, adt_q, dt_q = x[:, :, sl], Bh[:, :, sl], Ch[:, :, sl], adt[:, :, sl], dt[:, :, sl]
        xf = x_q.to(f32)
        # intra-chunk (the dual, attention-like form)
        L = torch.exp(_segsum(adt_q.transpose(2, 3)))  # (m, B, H, Q, Q)
        scores = matmul(C_q.permute(0, 1, 3, 2, 4), B_q.permute(0, 1, 3, 4, 2)).to(f32)  # (m, B, H, q, k)
        M = scores * L
        xdt = (xf * dt_q[..., None]).permute(0, 1, 3, 2, 4)  # (m, B, H, k, P)
        y_diag = matmul(M, xdt)  # (m, B, H, q, P)
        # the carried state's contribution to this chunk
        cs = cumsum(adt_q, 2)  # (m, B, Q, H)
        decay_in = torch.exp(cs)
        Cd = (C_q.to(f32) * decay_in[..., None]).permute(0, 1, 3, 2, 4)  # (m, B, H, q, N)
        y_off = matmul(Cd, state.transpose(-1, -2))  # (m, B, H, q, P)
        # the state for the next chunk
        seg = torch.sum(adt_q, dim=2)  # (m, B, H): the chunk's total decay
        decay_out = torch.exp(seg[:, :, None, :] - cs)  # (m, B, Q, H)
        w = dt_q * decay_out
        Bw = (B_q.to(f32) * w[..., None]).permute(0, 1, 3, 2, 4)  # (m, B, H, q, N)
        new_contrib = matmul(xf.permute(0, 1, 3, 4, 2), Bw)  # (m, B, H, P, N)
        state = state * torch.exp(seg)[..., None, None] + new_contrib
        ys.append((y_diag + y_off).to(x.dtype).permute(0, 1, 3, 2, 4))  # (m, B, q, H, P)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=2)
    return y, state


def _head_layout(t):
    """For a DTensor (m, B, ...) the mesh's placements factory ``place(batch,
    heads)`` (the batch dimension over the data axes where they divide it,
    ``heads`` on "model") and whether the model axis divides ``n`` heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]
    batch = t.shape[1] % math.prod(mesh.size(i) for i in data) == 0
    model = [i for i, n in enumerate(mesh.mesh_dim_names) if n == "model"]

    def place(on_batch, on_heads):
        return [(Shard(on_batch) if batch and on_batch is not None else Replicate()) if i in data
                else on_heads if i in model else Replicate() for i in range(mesh.ndim)]

    def divides(n):
        return all(n % mesh.size(i) == 0 for i in model)

    return place, divides, batch


def _ssd_sharded(cfg, x, B_mat, C_mat, dt, a_log, init_state=None):
    """`ssd_chunked` on DTensors (the dry run's sharded step): on each
    device's heads, split over the model axis as the reference's compiled
    step splits the scan (B and C, shared by every head, replicated; their
    gradients Partial sums over "model")."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    place, _, batch = _head_layout(x)
    per_data = Partial() if batch else Replicate()
    heads = place(1, Shard(3))
    shared, shared_grad = place(1, Replicate()), place(1, Partial())
    a_pl = [Shard(1) if isinstance(h, Shard) and h.dim == 3 else Replicate() for h in heads]
    a_grad = [per_data if isinstance(p, Shard) and p.dim == 1 else a for p, a in zip(heads, a_pl)]
    st = place(1, Shard(2))
    ins = (heads, shared, shared, place(1, Shard(3)), a_pl)
    grads = (heads, shared_grad, shared_grad, place(1, Shard(3)), a_grad)
    args = (x, B_mat, C_mat, dt, a_log)
    if init_state is not None:
        ins, grads, args = ins + (st,), grads + (st,), args + (init_state,)
    mesh = x.device_mesh
    model = [i for i, n in enumerate(mesh.mesh_dim_names) if n == "model"]
    rep = x.shape[3] // B_mat.shape[3]  # heads a group serves

    def local(x_, B_, C_, *rest):
        # this device's heads [h0, h0 + Hl) read the groups [g0, g1)
        Hl = x_.shape[3]
        h0 = shard_index(mesh, model)[0] * Hl
        g0, g1 = h0 // rep, (h0 + Hl - 1) // rep + 1
        return ssd_chunked(cfg, x_, B_[..., g0:g1, :], C_[..., g0:g1, :], *rest)

    fn = local_map(local, out_placements=(heads, st), in_placements=ins, in_grad_placements=grads,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def _in_columns(cfg, n: int) -> list:
    """The order of ``w_in``'s columns that gives each of ``n`` model shards,
    in shard order, its own heads' z and x, their dt, and its 1/n of B and
    C, in that order (the reference's columns run z, x, B, C, dt)."""
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    d_inner, bc = H * P, 2 * G * N
    hz, hd, nb = d_inner // n, H // n, bc // n
    cols = []
    for i in range(n):
        cols += [*range(i * hz, (i + 1) * hz), *range(d_inner + i * hz, d_inner + (i + 1) * hz),
                 *range(2 * d_inner + bc + i * hd, 2 * d_inner + bc + (i + 1) * hd),
                 *range(2 * d_inner + i * nb, 2 * d_inner + (i + 1) * nb)]
    return cols


def _sharded_on_heads(cfg, x) -> bool:
    """Whether a DTensor step can run this layer on each device's heads: the
    model axis divides the heads and B and C's columns."""
    if not is_dtensor(x):
        return False
    divides = _head_layout(x)[1]
    return divides(cfg.ssm_heads) and divides(2 * cfg.ssm_groups * cfg.ssm_state)


def _project_sharded(p: dict, cfg, x):
    """The input projection on DTensors, laid out on each device's heads:
    by a permutation of ``w_in``'s columns (`_in_columns`) under which each
    device's shard of the product holds its heads' z, x and dt and 1/n of
    B and C; or, where the device has fewer tokens than rows of ``w_in``
    (a decode step), by gathering the product and taking its heads'
    columns.  Returns z, the raw x and dt, sharded on their heads over
    "model", and the raw B and C gathered; and the conv's weights for x
    (sharded so) and for B and C."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    place = _head_layout(x)[0]
    mesh = x.device_mesh
    model = [i for i, nm in enumerate(mesh.mesh_dim_names) if nm == "model"]
    n = math.prod(mesh.size(i) for i in model)
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    d_inner, gn = H * P, 2 * G * N
    w = p["w_in"]
    sh = place(1, Shard(3))
    cols = _in_columns(cfg, n)
    shares = [cols[i * len(cols) // n:(i + 1) * len(cols) // n] for i in range(n)]

    def share(t):  # this device's share of the columns, from t gathered on them; its gradient there only
        return t[..., shares[shard_index(mesh, model)[0]]]

    def split(t):
        return torch.split(t, [d_inner // n, d_inner // n, H // n, gn // n], dim=-1)

    tokens = x.to_local().shape[1] * x.to_local().shape[2]
    if tokens <= w.to_local().shape[1]:  # fewer tokens than w's rows here: the projection moves, not w
        z, x_raw, dt_raw, bc = local_map(lambda t: split(share(t)), out_placements=(sh,) * 4,
                                         in_placements=(place(1, Replicate()),),
                                         in_grad_placements=(place(1, Partial()),), device_mesh=mesh,
                                         redistribute_inputs=True)(linear(x, w))
    else:
        whole = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in w.placements]
        w = local_map(share, out_placements=list(w.placements), in_placements=(whole,),
                      in_grad_placements=([Partial() if isinstance(pl, Shard) and pl.dim == 2 else pl
                                           for pl in w.placements],),
                      device_mesh=mesh, redistribute_inputs=True)(w)
        z, x_raw, dt_raw, bc = local_map(split, out_placements=(sh,) * 4, in_placements=(sh,), device_mesh=mesh,
                                         redistribute_inputs=True)(linear(x, w))
    bc = bc.redistribute(mesh, place(1, Replicate()))
    cw = p["conv_w"].redistribute(mesh, [Replicate()] * mesh.ndim)
    cw_x = cw[:, :, :d_inner].redistribute(mesh, place(None, Shard(2)))
    return z, x_raw, dt_raw, bc, cw_x, cw[:, :, d_inner:]


def _mamba_apply_sharded(p: dict, cfg, x, state, return_cache: bool):
    """`mamba_apply` on DTensors (the dry run's sharded step) on each
    device's heads (`_project_sharded`, `_ssd_sharded`): the conv of x on
    its heads' channels, B and C's on every device; the gated norm's mean
    reduced across the heads' shards."""
    m, Bsz, S, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, x_raw, dt_raw, bc_raw, cw_x, cw_bc = _project_sharded(p, cfg, x)
    x_in = _causal_conv(x_raw, cw_x)
    B_mat, C_mat = torch.split(_causal_conv(bc_raw, cw_bc), [G * N, G * N], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][:, None, None, :])
    xh = x_in.reshape(m, Bsz, S, H, P)
    y, final_state = _ssd_sharded(cfg, xh, B_mat.reshape(m, Bsz, S, G, N), C_mat.reshape(m, Bsz, S, G, N), dt,
                                  p["a_log"], init_state=state)
    y = y + xh * p["d_skip"][:, None, None, :, None].to(y.dtype)
    y = rms_norm(y.reshape(m, Bsz, S, H * P) * _silu(z), p["norm"])
    out = linear(y, p["w_out"])
    if not return_cache:
        return out, final_state
    from torch.distributed.tensor import Replicate

    x_tail = x_raw[:, :, -(D_CONV - 1):]
    x_tail = x_tail.redistribute(x_tail.device_mesh, [Replicate() if getattr(pl, "dim", None) == 3 else pl
                                                      for pl in x_tail.placements])
    tail = torch.cat([x_tail, bc_raw[:, :, -(D_CONV - 1):]], dim=-1)
    if tail.shape[2] < D_CONV - 1:
        tail = pad_front(tail, 2, D_CONV - 1 - tail.shape[2])
    return out, {"state": final_state, "conv": tail}


def mamba_apply(p: dict, cfg, x: torch.Tensor, state=None, return_cache: bool = False):
    """The layer's train / prefill forward.  x (m, B, S, D).  Returns (out,
    final_state), or (out, {"state", "conv"}) with ``return_cache``: the
    conv cache holds the last D_CONV - 1 raw (pre-activation) conv inputs."""
    if _sharded_on_heads(cfg, x):
        return _mamba_apply_sharded(p, cfg, x, state, return_cache)
    m, Bsz, S, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    proj = linear(x, p["w_in"])
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, p["conv_w"])
    x_in, B_mat, C_mat = torch.split(xBC, [H * P, G * N, G * N], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"][:, None, None, :])  # (m, B, S, H)
    xh = x_in.reshape(m, Bsz, S, H, P)
    y, final_state = ssd_chunked(cfg, xh, B_mat.reshape(m, Bsz, S, G, N), C_mat.reshape(m, Bsz, S, G, N), dt,
                                 p["a_log"], init_state=state)
    y = y + xh * p["d_skip"][:, None, None, :, None].to(y.dtype)
    y = y.reshape(m, Bsz, S, H * P)
    y = rms_norm(y * _silu(z), p["norm"])
    out = linear(y, p["w_out"])
    if return_cache:
        tail = xBC_raw[:, :, -(D_CONV - 1):]
        pad = D_CONV - 1 - tail.shape[2]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, {"state": final_state, "conv": tail}
    return out, final_state


def make_ssm_cache(cfg, m: int, batch: int, dtype=None, device=None) -> dict:
    """One layer's decode cache, node-stacked: the f32 state (m, B, H, P, N)
    and the conv inputs (m, B, D_CONV - 1, conv_dim)."""
    _, conv_dim = ssm_dims(cfg)
    return {
        "state": torch.zeros((m, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((m, batch, D_CONV - 1, conv_dim), dtype=dtype or cfg.dtype, device=device),
    }


def ssm_cache_specs() -> dict:
    """The cache tree's logical axes, as the reference names them (the node
    axis in front is not one of them)."""
    return {"state": ("batch", None, None, None), "conv": ("batch", None, None)}


def _decode_inputs_sharded(p: dict, cfg, x_t, conv_in):
    """A decode step's z, activated x, B and C, raw dt and new conv cache on
    DTensors, on each device's heads (`_project_sharded`): z, x and dt
    sharded on their heads over "model", B and C on every device; the conv
    cache (replicated, the reference's layout) read on the same split and
    written whole."""
    from torch.distributed.tensor import Replicate, Shard

    place = _head_layout(x_t)[0]
    mesh = x_t.device_mesh
    G, N = cfg.ssm_groups, cfg.ssm_state
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    z, x_raw, dt_raw, bc_raw, cw_x, cw_bc = _project_sharded(p, cfg, x_t)
    x_in = _causal_conv(x_raw, cw_x, conv_state=conv_in[..., :d_inner].redistribute(mesh, place(1, Shard(3))))
    B_mat, C_mat = torch.split(_causal_conv(bc_raw, cw_bc, conv_state=conv_in[..., d_inner:]), [G * N, G * N],
                               dim=-1)
    x_whole = x_raw.redistribute(mesh, place(1, Replicate()))  # one token
    new_conv = torch.cat([conv_in[:, :, 1:], torch.cat([x_whole, bc_raw], dim=-1)], dim=2)
    return z, x_in, B_mat, C_mat, dt_raw, new_conv


def mamba_decode(p: dict, cfg, x_t: torch.Tensor, cache: dict):
    """One-token decode.  x_t (m, B, 1, D).  Returns (out (m, B, 1, D),
    new_cache); the cache given is not changed."""
    m, Bsz = x_t.shape[0], x_t.shape[1]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    f32 = torch.float32
    conv_in = cache["conv"]
    if _sharded_on_heads(cfg, x_t):
        z, x_in, B_mat, C_mat, dt_raw, new_conv = _decode_inputs_sharded(p, cfg, x_t, conv_in)
    else:
        proj = linear(x_t, p["w_in"])
        z, xBC, dt_raw = _split_proj(cfg, proj)
        xBC_act = _causal_conv(xBC, p["conv_w"], conv_state=conv_in)
        new_conv = torch.cat([conv_in[:, :, 1:], xBC], dim=2)
        x_in, B_mat, C_mat = torch.split(xBC_act, [H * P, G * N, G * N], dim=-1)
    x_in = x_in.reshape(m, Bsz, H, P)
    rep = H // G
    B_v = B_mat.reshape(m, Bsz, G, N)
    C_v = C_mat.reshape(m, Bsz, G, N)
    if rep > 1:
        B_v, C_v = torch.repeat_interleave(B_v, rep, dim=2), torch.repeat_interleave(C_v, rep, dim=2)
    dt = softplus(dt_raw.to(f32)[:, :, 0] + p["dt_bias"][:, None, :])  # (m, B, H)
    A = -torch.exp(p["a_log"])
    da = torch.exp(A[:, None] * dt)  # (m, B, H)
    Bdt = B_v.to(f32) * dt[..., None]  # (m, B, H, N)
    state = cache["state"] * da[..., None, None] + x_in.to(f32)[..., :, None] * Bdt[..., None, :]
    y = matmul(state, C_v.to(f32)[..., None])[..., 0]  # (m, B, H, P)
    y = y + x_in.to(f32) * p["d_skip"][:, None, :, None]
    y = y.reshape(m, Bsz, 1, H * P).to(x_t.dtype)
    y = rms_norm(y * _silu(z), p["norm"])
    return linear(y, p["w_out"]), {"state": state, "conv": new_conv}
