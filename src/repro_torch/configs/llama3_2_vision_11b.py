"""Llama-3.2-11B-Vision [hf]: text backbone w/ cross-attn image layers.

40 layers = 8 scan groups x (4 self + 1 cross).  Vision frontend is a STUB:
input_specs provides precomputed patch embeddings [B, 1601, 7680].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=500_000.0,
    cross_attn_tokens=1601, cross_attn_dim=7680,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          cross_attn_tokens=17, cross_attn_dim=48,
                          dtype="float32")
