"""The framework's LM architectures (``repro.models``'s counterparts): the
shared layers, GQA attention, the Mamba-2 SSD layer, the top-k MoE with
capacity dispatch, the transformer (dense, MoE, SSM, hybrid, VLM, and the
audio encoder-decoder) and the recompute of its checkpointed regions.
Every tensor carries a leading node axis (`repro_torch.models.layers`).
The train, prefill and serve steps and the transformer's decode path are
not ported yet."""
