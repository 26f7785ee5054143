"""Checkpoints in the reference's msgpack format (``repro.checkpoint``'s
counterpart)."""

from repro_torch.checkpoint.io import (  # noqa: F401
    checkpoint_path,
    latest_checkpoint,
    load_pytree,
    save_pytree,
)
