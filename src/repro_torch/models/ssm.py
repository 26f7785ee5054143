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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _silu, dense_init, init_device, linear, normal, rms_norm, uniform
from repro_torch.models.sharded import cumsum, matmul, pad_front

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


def mamba_apply(p: dict, cfg, x: torch.Tensor, state=None, return_cache: bool = False):
    """The layer's train / prefill forward.  x (m, B, S, D).  Returns (out,
    final_state), or (out, {"state", "conv"}) with ``return_cache``: the
    conv cache holds the last D_CONV - 1 raw (pre-activation) conv inputs."""
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


def mamba_decode(p: dict, cfg, x_t: torch.Tensor, cache: dict):
    """One-token decode.  x_t (m, B, 1, D).  Returns (out (m, B, 1, D),
    new_cache); the cache given is not changed."""
    m, Bsz = x_t.shape[0], x_t.shape[1]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    f32 = torch.float32
    proj = linear(x_t, p["w_in"])
    z, xBC, dt_raw = _split_proj(cfg, proj)
    conv_in = cache["conv"]
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
