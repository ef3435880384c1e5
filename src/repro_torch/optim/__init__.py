"""Optimizers over dict trees of tensors, with the JAX package's update
math (``repro.optim``): AdamW, Adafactor, SGD with momentum, the cosine
schedule, global-norm clipping.

Not ``torch.optim``: bias correction from ``step + 1``, weight decay on
every leaf, Adafactor's factored moments over each leaf's last two dims and
f32 state, as the reference computes them.
"""
from .optimizers import (
    OptState, Optimizer, adafactor, adamw, apply_updates,
    clip_by_global_norm, cosine_schedule, make_optimizer, sgdm,
)

__all__ = [
    "OptState", "Optimizer", "adafactor", "adamw", "apply_updates",
    "clip_by_global_norm", "cosine_schedule", "make_optimizer", "sgdm",
]
