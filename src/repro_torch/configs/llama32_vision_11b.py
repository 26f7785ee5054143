"""llama-3.2-vision-11b — decoder LM with cross-attention image layers every
5th layer; the ViT/projector frontend is a STUB supplying patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=("full", "full", "full", "full", "cross"),
    num_patches=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    arch_type="vlm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("full", "cross"),
    num_patches=64,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
