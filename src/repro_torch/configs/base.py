"""Architecture + input-shape configuration system
(``repro.configs.base``'s counterpart).

`ModelConfig` and `InputShape` are the reference's frozen dataclasses, field
for field; the parameter dtype defaults to ``torch.bfloat16`` where the
reference's defaults to ``jnp.bfloat16``.  `param_count` and
`active_param_count` are the reference's arithmetic, unchanged."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # per-layer kind pattern, repeated num_layers/len(pattern) times.
    # kinds: "full" | "swa" | "mamba" | "cross"
    pattern: tuple = ("full",)

    # MLP
    mlp_type: str = "swiglu"  # swiglu | squared_relu | gelu
    qkv_bias: bool = False

    # attention
    rope_theta: float = 10_000.0
    use_rope: bool = True  # jamba attention layers carry no position encoding
    window: int | None = None
    logit_softcap: float | None = None
    attn_softcap: float | None = None

    # MoE (num_experts == 0 -> dense MLP)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_period: int = 1  # MoE on layers where (layer_idx % moe_period == moe_offset)
    moe_offset: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256

    # encoder-decoder (audio)
    enc_layers: int = 0
    enc_seq_ratio: int = 8  # encoder frames = target_len // ratio (stub frontend)

    # vlm
    num_patches: int = 0  # cross-attn memory length from the vision stub

    # misc
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    scale_embed: bool = False  # gemma-style sqrt(d_model) embedding scale
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | none (see transformer.py)

    # citation for the assigned-architecture provenance
    source: str = ""

    def __post_init__(self):
        assert self.num_layers % len(self.pattern) == 0, (
            self.name,
            self.num_layers,
            self.pattern,
        )
        if "full" in self.pattern or "swa" in self.pattern or "cross" in self.pattern:
            assert self.num_heads % self.num_kv_heads == 0

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    def layer_kind(self, p: int) -> str:
        return self.pattern[p]

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (
            self.num_experts > 0
            and layer_idx % self.moe_period == self.moe_offset
        )

    # parameter counts ------------------------------------------------------
    def param_count(self) -> int:
        """Exact-ish analytic parameter count (cross-checked in tests)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d  # lm head
        total += d  # final norm

        def attn_p():
            p = d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                p += H * hd + 2 * KV * hd
            return p

        def mlp_p():
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            return mult * d * f

        def moe_p():
            return self.num_experts * 3 * d * f + d * self.num_experts

        def mamba_p():
            d_inner = self.ssm_heads * self.ssm_head_dim
            conv_dim = d_inner + 2 * self.ssm_groups * self.ssm_state
            in_dim = 2 * d_inner + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads
            return (
                d * in_dim + d_inner * d + 4 * conv_dim
                + 3 * self.ssm_heads + d_inner
            )

        for li in range(self.num_layers):
            kind = self.pattern[li % len(self.pattern)]
            total += d  # norm1
            if kind == "mamba":
                total += mamba_p()
            else:
                total += attn_p()
            if self.arch_type == "audio":  # decoder cross-attn sublayer
                total += attn_p() + d
            if f > 0:
                total += d  # norm2
                # every block carries an MLP/MoE slot; archs without one set
                # d_ff = 0 (mamba2), which zeroes this term.
                total += moe_p() if self.is_moe_layer(li) else mlp_p()
        # encoder (audio): attn + mlp blocks, bidirectional
        for _ in range(self.enc_layers):
            total += attn_p() + mlp_p() + 2 * d
        if self.enc_layers:
            total += d  # encoder final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive_experts = self.num_experts - self.num_experts_per_tok
        n_moe_layers = sum(
            1 for li in range(self.num_layers) if self.is_moe_layer(li)
        )
        return self.param_count() - n_moe_layers * inactive_experts * 3 * d * f


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[
            self.kind
        ]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
