"""gemma2-27b — dense, local(4096)+global alternating attention, logit
softcaps, GeGLU, tied embeddings. [arXiv:2408.00118]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("swa", "full"),
    window=4096,
    mlp_type="geglu",
    logit_softcap=30.0,
    attn_softcap=50.0,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2408.00118",
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    arch_type="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("swa", "full"),
    window=64,
    mlp_type="geglu",
    logit_softcap=30.0,
    attn_softcap=50.0,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2408.00118",
)
