"""seamless-m4t-medium — encoder-decoder multimodal (speech) backbone.
The mel-spectrogram/conv frontend is a STUB: input_specs() provides
precomputed frame embeddings. [arXiv:2308.11596]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,             # decoder
    enc_layers=12,             # speech encoder over stub frame embeddings
    enc_seq_ratio=8,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=("full",),
    mlp_type="gelu",
    source="arXiv:2308.11596",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    arch_type="audio",
    num_layers=2,
    enc_layers=2,
    enc_seq_ratio=8,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("full",),
    mlp_type="gelu",
    source="arXiv:2308.11596",
)
