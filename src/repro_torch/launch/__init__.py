"""The framework's launchers (``repro.launch``'s counterparts): ``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.serve`` and the
launch planner ``python -m repro_torch.launch.dryrun`` (with ``mesh`` and
``roofline``)."""

from __future__ import annotations

import torch


def normal(generator: torch.Generator, shape: tuple, dtype) -> torch.Tensor:
    """A standard normal stub input (frame embeddings, image patches), drawn
    in f32 on the generator's device and cast to ``dtype``."""
    return torch.randn(shape, generator=generator, device=generator.device).to(dtype)
