"""mixtral-8x7b — 8-expert top-2 MoE, GQA kv=8, sliding window. [arXiv:2401.04088]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=("swa",),
    window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_period=1,
    source="arXiv:2401.04088",
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    arch_type="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("swa",),
    window=64,
    num_experts=4,
    num_experts_per_tok=2,
    moe_period=1,
    source="arXiv:2401.04088",
)
