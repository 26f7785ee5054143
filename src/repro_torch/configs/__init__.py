"""Architecture registry (``repro.configs``'s counterpart): `get_config`,
`ARCH_NAMES`, `LONG_CONTEXT_ARCHS`, `shape_applicable` and `input_specs`
(a step's inputs as tensors on the ``meta`` device, PyTorch's stand-in for
an unallocated array where the reference uses ``jax.ShapeDtypeStruct``)."""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_ARCH_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen2-7b": "qwen2_7b",
    "gemma2-27b": "gemma2_27b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)

# long_500k applies to the archs whose decode is sub-quadratic
LONG_CONTEXT_ARCHS = frozenset(
    {
        "mamba2-2.7b",
        "jamba-1.5-large-398b",
        "mixtral-8x7b",
        "mixtral-8x22b",
        "gemma2-27b",
    }
)

__all__ = ["ARCH_NAMES", "INPUT_SHAPES", "LONG_CONTEXT_ARCHS", "InputShape", "ModelConfig", "get_config",
           "input_specs", "shape_applicable"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) runs; the reason when it is skipped."""
    if shape.name == "long_500k":
        if cfg.name in _ARCH_MODULES and cfg.name not in LONG_CONTEXT_ARCHS:
            return False, "full-attention arch: 524k dense KV decode skipped"
    return True, ""


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Every model input of a step as a ``meta`` tensor: no allocation.

    train:   tokens + labels (+ modality stub embeddings)
    prefill: tokens (+ stubs)
    decode:  one token + position + KV caches of shape.seq_len (+ stubs)
    """
    from repro_torch.models.transformer import init_caches

    B, S = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = meta(B, S)
        specs["labels"] = meta(B, S)
    elif shape.kind == "prefill":
        specs["tokens"] = meta(B, S)
    else:  # decode
        specs["token"] = meta(B)
        specs["pos"] = meta()
        specs["caches"] = init_caches(cfg, B, S, dtype=cfg.dtype, device="meta")
    if cfg.arch_type == "audio":
        s_enc = max(cfg.enc_seq_ratio, S // cfg.enc_seq_ratio)
        # decode reads a fixed encoder memory
        specs["memory" if shape.kind == "decode" else "enc_embeds"] = meta(B, s_enc, cfg.d_model, dtype=cfg.dtype)
    if cfg.arch_type == "vlm":
        specs["memory"] = meta(B, cfg.num_patches, cfg.d_model, dtype=cfg.dtype)
    return specs
