"""The framework's LM architectures (``repro.models``'s counterparts): the
shared layers, GQA attention, the Mamba-2 SSD layer, the top-k MoE with
capacity dispatch, the transformer (dense, MoE, SSM, hybrid, VLM, and the
audio encoder-decoder) with its decode path, the recompute of its
checkpointed regions, and the train, prefill and serve steps
(`repro_torch.models.steps`).  Every tensor of the model functions carries
a leading node axis (`repro_torch.models.layers`); the decode path and the
steps take one model's tree, without it."""
