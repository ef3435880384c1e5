"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Backbone only; the EnCodec frontend is a STUB — inputs are 4 parallel
codebook token streams [B, S, 4] (delay-pattern handling lives in the
application layer, not the backbone).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    pattern=("attn",), n_codebooks=4, mlp_act="gelu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=64, head_dim=16, n_codebooks=4,
                          dtype="float32")
