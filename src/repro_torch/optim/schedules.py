"""Learning-rate schedules (``repro.optim.schedules``'s counterpart): plain
functions of an integer step.

The reference computes in f32 (its step is an int32 array cast to f32, the
Python numbers weakly typed); these functions do the same arithmetic on
numpy f32 scalars, op by op in the reference's order, and return the f32
value as a Python float.  The cosine is the f64 one rounded to f32 (the
correctly rounded value); XLA's f32 cosine is within one ulp of it, so a
cosine schedule's values may part from the reference's by an ulp or two."""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def linear_warmup(step: int, base_lr: float, warmup_steps: int) -> float:
    frac = min(_F32(step) / _F32(max(warmup_steps, 1)), _F32(1.0))
    return float(_F32(base_lr) * frac)


def cosine_schedule(step: int, base_lr: float, total_steps: int, warmup_steps: int = 0,
                    min_frac: float = 0.1) -> float:
    s = _F32(step)
    warm = min(s / _F32(max(warmup_steps, 1)), _F32(1.0)) if warmup_steps else 1.0
    progress = np.clip((s - _F32(warmup_steps)) / _F32(max(total_steps - warmup_steps, 1)), _F32(0.0), _F32(1.0))
    cos = _F32(min_frac) + _F32(1 - min_frac) * _F32(0.5) * (_F32(1) + _F32(np.cos(np.float64(_F32(np.pi) * progress))))
    lr_warm = _F32(base_lr) * warm if warmup_steps else _F32(base_lr * warm)
    return float(lr_warm * cos)
