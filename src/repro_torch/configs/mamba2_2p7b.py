"""mamba2-2.7b — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # mamba2 blocks carry no MLP
    vocab_size=50280,
    pattern=("mamba",),
    ssm_state=128,
    ssm_heads=80,              # d_inner = 2*d_model = 5120 = 80 * 64
    ssm_head_dim=64,
    ssm_groups=1,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    arch_type="ssm",
    num_layers=2,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=512,
    pattern=("mamba",),
    ssm_state=32,
    ssm_heads=8,               # d_inner = 512 = 8 * 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=32,
    source="arXiv:2405.21060",
)
