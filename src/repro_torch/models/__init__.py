"""The framework's LM architectures (``repro.models``'s counterparts): the
shared layers, GQA attention, the dense decoder-only transformer and the
recompute of its checkpointed regions.  Every tensor carries a leading
node axis (`repro_torch.models.layers`)."""
