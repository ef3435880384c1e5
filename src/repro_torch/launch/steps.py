"""Step builders: the serve step (greedy decode).  Train steps come with
the train slice."""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """One-token decode step with greedy argmax over the last position."""

    def serve_step(params, cache, token, pos):
        logits, cache = M.decode_step(cfg, params, token, cache, pos)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step
