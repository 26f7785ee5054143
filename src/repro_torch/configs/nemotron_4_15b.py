"""nemotron-4-15b — dense, GQA kv=8, squared-ReLU MLP, 256k vocab. [arXiv:2402.16819]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    pattern=("full",),
    mlp_type="squared_relu",
    source="arXiv:2402.16819",
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=1024,
    pattern=("full",),
    mlp_type="squared_relu",
    source="arXiv:2402.16819",
)
