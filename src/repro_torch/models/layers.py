"""Building blocks shared by every architecture (``repro.models.layers``'s
counterpart).

Node-stacked layout: every parameter and every activation carries a
leading NODE axis ``m`` (the decentralized nodes of a bilevel run, each
with its own copy of the model), and the node axis is a batch axis of
every product (`linear`: one ``bmm`` over the nodes), where the reference
writes one model's arrays and vmaps its losses over the nodes.  A single
model is ``m = 1``.  Parameters are plain nested dicts of tensors; the
init functions draw from a passed-in ``torch.Generator`` with the
reference's distributions and scales (a normal times 1/sqrt(in_dim) for a
dense weight, times 0.02 for an embedding; ones for a norm, zeros for a
bias), and return the tensor only: the reference's logical-axis specs
feed its mesh sharding, which has no counterpart on one card.

The reference's activation-sharding and weight-gathering hooks
(``set_activation_constraint``, ``gather_weight``) pin layouts on a TPU
mesh and are identities without one; the port runs on one device, so they
are left out.

Arithmetic follows the reference op by op, in its dtypes: norms and RoPE
in f32, cast back to the activation's dtype; ``jax.nn.gelu``'s default is
the tanh approximation, so ``gelu`` here is ``approximate="tanh"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.remat import checkpoint

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator, dtype=torch.float32, device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32, device=generator.device)
    return (w * 0.02).to(dtype)


def norm_init(dim: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def bias_init(dim: int, dtype, device=None) -> torch.Tensor:
    return torch.zeros((dim,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# node-batched products
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` node by node: x (m, ..., in), w (m, in, out) -> (m, ..., out),
    one batched product over the nodes."""
    m = x.shape[0]
    out = torch.bmm(x.reshape(m, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _per_node(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-node vector (m, d) shaped to broadcast against x (m, ..., d)."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (m, ..., d), scale (m, d)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * _per_node(scale, x).to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * _per_node(scale, x).to(torch.float32) + _per_node(bias, x).to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.  The
    split-half rotation (not interleaved), in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, cfg) -> dict:
    """The configured MLP's weights (wi, wg, wo for the gated types; wi, wo
    otherwise), drawn in that order."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        wi = dense_init(generator, d, f, dt)
        wg = dense_init(generator, d, f, dt)
        wo = dense_init(generator, f, d, dt)
        return {"wi": wi, "wg": wg, "wo": wo}
    wi = dense_init(generator, d, f, dt)
    wo = dense_init(generator, f, d, dt)
    return {"wi": wi, "wo": wo}


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, x * sigmoid(x), as written (``F.silu``'s backward
    traces to in-place operators, which the oracle graphs refuse)."""
    return x * torch.sigmoid(x)


def mlp_apply(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = _silu(linear(x, p["wg"])) * linear(x, p["wi"])
    elif mlp_type == "geglu":
        h = F.gelu(linear(x, p["wg"]), approximate="tanh") * linear(x, p["wi"])
    elif mlp_type == "squared_relu":
        h = torch.square(F.relu(linear(x, p["wi"])))
    elif mlp_type == "gelu":
        h = F.gelu(linear(x, p["wi"]), approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return linear(h, p["wo"])


# ---------------------------------------------------------------------------
# softcap + losses
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def _chunk_nll(h: torch.Tensor, lab: torch.Tensor, mk: torch.Tensor, lm_head: torch.Tensor, logit_cap):
    """One sequence chunk: the masked NLL sum and the mask count, per node.
    h (m, B, c, D), lab / mk (m, B, c), lm_head (m, D, V)."""
    logits = linear(h, lm_head).to(torch.float32)
    logits = softcap(logits, logit_cap)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return torch.sum(nll * mk, dim=(1, 2)), torch.sum(mk, dim=(1, 2))


def chunked_cross_entropy(
    hidden: torch.Tensor, labels: torch.Tensor, lm_head: torch.Tensor, chunk: int = 512, logit_cap=None, mask=None
) -> torch.Tensor:
    """Each node's mean cross-entropy over a big vocab, one sequence chunk of
    (B, chunk, V) logits at a time.

    hidden: (m, B, S, D); labels: (m, B, S) integers; lm_head: (m, D, V).
    Returns (m,).  Each chunk's logits are recomputed in the backward pass
    instead of saved (`repro_torch.models.remat.checkpoint`), as the
    reference's ``jax.checkpoint`` does."""
    m, B, S, D = hidden.shape
    assert S % chunk == 0, (S, chunk)
    ms = torch.ones_like(labels, dtype=torch.float32) if mask is None else mask.to(torch.float32)
    tot = torch.zeros((m,), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((m,), dtype=torch.float32, device=hidden.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll, n = checkpoint(_chunk_nll, hidden[:, :, sl], labels[:, :, sl], ms[:, :, sl], lm_head, logit_cap)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)
