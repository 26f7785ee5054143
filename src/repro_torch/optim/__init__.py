"""Optimizers and learning-rate schedules (``repro.optim``'s counterpart)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_optimizer,
    sgdm_init,
    sgdm_update,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
