"""phi3-mini-3.8b — dense, RoPE SwiGLU, MHA (kv == heads). [arXiv:2404.14219]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    pattern=("full",),
    mlp_type="swiglu",
    source="arXiv:2404.14219",
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("full",),
    mlp_type="swiglu",
    source="arXiv:2404.14219",
)
