"""Optimizers over dict trees of tensors, with the JAX package's update
math (``repro.optim``): AdamW, the cosine schedule, global-norm clipping.

Not ``torch.optim``: bias correction from ``step + 1``, weight decay on
every leaf and f32 state, as the reference computes them.  Adafactor and
SGD with momentum come with ROADMAP Queue 1 item 3.
"""
from .optimizers import (
    OptState, Optimizer, adamw, apply_updates, clip_by_global_norm,
    cosine_schedule,
)

__all__ = [
    "OptState", "Optimizer", "adamw", "apply_updates",
    "clip_by_global_norm", "cosine_schedule",
]
