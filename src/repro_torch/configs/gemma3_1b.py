"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 5:1 local:global attention, 128k ctx.

26 layers = 4 scan groups x (5 local + 1 global) + 2 local tail.
Sliding window 512 for local layers.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    pattern=("attn_local",) * 5 + ("attn",),
    tail=("attn_local", "attn_local"),
    window=512, rope_theta=1_000_000.0, tie_embeddings=True,
    mlp_act="gelu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=8, d_model=48, n_heads=2, n_kv_heads=1,
                          d_ff=96, vocab=256, head_dim=24, window=8,
                          dtype="float32")
