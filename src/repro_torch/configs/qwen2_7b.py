"""qwen2-7b — dense, GQA kv=4, QKV bias. [arXiv:2407.10671]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=("full",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("full",),
    qkv_bias=True,
    source="arXiv:2407.10671",
)
