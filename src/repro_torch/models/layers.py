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
bias).  As in the reference, every init returns ``(tensor, axes)``
beside each other: the leaf and its LOGICAL axes, a tuple of names
(``"embed"``, ``"ffn"``, ...) or None for each of its dimensions, which
`repro_torch.sharding.partitioning` resolves against a mesh.  The axes
describe one model's leaf (no node axis).  With ``generator=None`` the
inits draw nothing and allocate nothing: every leaf is a ``meta`` tensor
of its shape and dtype (`repro_torch.models.transformer.abstract_lm_params`).

The sharding hooks, as the reference's: a launcher installs
``set_activation_constraint(fn)`` (the dry run's pins a DTensor
activation's batch over the data axes, `repro_torch.launch.dryrun`) and
the model calls `shard_activation` where the reference does;
``set_weight_gather`` / `gather_weight` are set by the dry run and called
nowhere, as in the reference.  Both are identities while unset.  An
activation here carries the node axis in front, so the reference's
leading (batch) dimension is dimension 1.

Arithmetic follows the reference op by op, in its dtypes: norms and RoPE
in f32, cast back to the activation's dtype; ``jax.nn.gelu``'s default is
the tanh approximation, so ``gelu`` here is ``approximate="tanh"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.remat import checkpoint, product
from repro_torch.models.sharded import (
    bmm,
    idle_model_dims,
    idle_model_head,
    is_dtensor,
    rms_norm_on_shards,
    shard_dims,
    vocab_parallel_nll,
)

# ---------------------------------------------------------------------------
# sharding hooks
# ---------------------------------------------------------------------------

_ACT_CONSTRAINT = None
_WEIGHT_GATHER = None


def set_activation_constraint(fn) -> None:
    """fn(x) -> x pinned to a layout (batch, dimension 1, over the data
    axes), or None to unset."""
    global _ACT_CONSTRAINT
    _ACT_CONSTRAINT = fn


def shard_activation(x: torch.Tensor) -> torch.Tensor:
    if _ACT_CONSTRAINT is None:
        return x
    return _ACT_CONSTRAINT(x)


def set_weight_gather(fn) -> None:
    """fn(w) -> w replicated over the data axes (its last dimension over
    "model"), or None to unset."""
    global _WEIGHT_GATHER
    _WEIGHT_GATHER = fn


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    if _WEIGHT_GATHER is None:
        return w
    return _WEIGHT_GATHER(w)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def init_device(generator: torch.Generator | None) -> torch.device:
    """Where an init puts its leaves: the generator's device, or ``meta``
    without one."""
    return torch.device("meta") if generator is None else generator.device


def normal(generator: torch.Generator | None, shape: tuple) -> torch.Tensor:
    """f32 standard normals of ``shape`` from ``generator``; without one, a
    meta tensor (no draw)."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)


def uniform(generator: torch.Generator | None, shape: tuple) -> torch.Tensor:
    """f32 uniforms on [0, 1) of ``shape`` from ``generator``; without one,
    a meta tensor (no draw)."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=generator.device)


def dense_init(generator, in_dim: int, out_dim: int, in_ax, out_ax, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (normal(generator, (in_dim, out_dim)) * scale).to(dtype), (in_ax, out_ax)


def embed_init(generator, vocab: int, dim: int, dtype):
    return (normal(generator, (vocab, dim)) * 0.02).to(dtype), ("vocab", "embed")


def norm_init(dim: int, dtype, device=None):
    return torch.ones((dim,), dtype=dtype, device=device), (None,)


def bias_init(dim: int, ax, dtype, device=None):
    return torch.zeros((dim,), dtype=dtype, device=device), (ax,)


# ---------------------------------------------------------------------------
# node-batched products
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` node by node: x (m, ..., in), w (m, in, out) -> (m, ..., out),
    one batched product over the nodes.  With one node (m = 1, the one-model
    steps) it is the reference's product with no batch dimension, whose
    output the ``"dots"`` recompute policy keeps (`remat.product`)."""
    m = x.shape[0]
    x2 = x.reshape(m, -1, x.shape[-1])
    out = product(x2, w) if m == 1 else bmm(x2, w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def head_linear(x: torch.Tensor, w: torch.Tensor, serve: bool = False) -> torch.Tensor:
    """`linear` for the LM head (of a serve step with ``serve``); on DTensors
    whose vocabulary the model axis leaves whole,
    `repro_torch.models.sharded.idle_model_head`."""
    if not (is_dtensor(w) and idle_model_dims(w)):
        return linear(x, w)
    m = x.shape[0]
    out = idle_model_head(x.reshape(m, -1, x.shape[-1]), w, serve)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _per_node(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-node vector (m, d) shaped to broadcast against x (m, ..., d)."""
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (m, ..., d), scale (m, d).  A DTensor sharded on d is normalized
    on its shards (`repro_torch.models.sharded.rms_norm_on_shards`)."""
    if is_dtensor(x) and shard_dims(x, -1):
        return rms_norm_on_shards(x, scale, eps)
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


def mlp_init(generator, cfg) -> tuple[dict, dict]:
    """The configured MLP's weights (wi, wg, wo for the gated types; wi, wo
    otherwise), drawn in that order, and their axes."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    wi, si = dense_init(generator, d, f, "embed", "ffn", dt)
    if cfg.mlp_type in ("swiglu", "geglu"):
        wg, sg = dense_init(generator, d, f, "embed", "ffn", dt)
        wo, so = dense_init(generator, f, d, "ffn", "embed", dt)
        return {"wi": wi, "wg": wg, "wo": wo}, {"wi": si, "wg": sg, "wo": so}
    wo, so = dense_init(generator, f, d, "ffn", "embed", dt)
    return {"wi": wi, "wo": wo}, {"wi": si, "wo": so}


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
    logits = head_linear(h, lm_head).to(torch.float32)
    logits = softcap(logits, logit_cap)
    if is_dtensor(logits):  # the dry run's sharded step: the vocabulary stays sharded
        nll = vocab_parallel_nll(logits, lab)
    else:
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
    reference's ``jax.checkpoint`` does.  On DTensors the logits stay
    sharded on the vocabulary as ``lm_head`` is
    (`repro_torch.models.sharded.vocab_parallel_nll`)."""
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
