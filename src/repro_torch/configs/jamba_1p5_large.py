"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, 16-expert top-2 MoE
every other layer. [arXiv:2403.19887]"""

from repro_torch.configs.base import ModelConfig

# period of 8: one attention layer per 7 mamba layers (1:7 interleave);
# MoE replaces the MLP on every other layer (odd offsets).
_PATTERN = ("mamba", "mamba", "mamba", "full", "mamba", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    use_rope=False,            # Jamba attention carries no position encoding
    num_experts=16,
    num_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    ssm_state=128,
    ssm_heads=256,             # d_inner = 2*d_model = 16384 = 256 * 64
    ssm_head_dim=64,
    ssm_groups=8,
    source="arXiv:2403.19887",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    arch_type="hybrid",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("mamba", "full"),
    use_rope=False,
    num_experts=4,
    num_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    ssm_state=32,
    ssm_heads=8,
    ssm_head_dim=64,
    ssm_groups=2,
    ssm_chunk=32,
    source="arXiv:2403.19887",
)
