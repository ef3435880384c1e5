"""Qwen2-0.5B [arXiv:2407.10671]: GQA with QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True,
    pattern=("attn",), rope_theta=1_000_000.0, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=56, n_heads=7, n_kv_heads=1,
                          d_ff=128, vocab=256, head_dim=8, dtype="float32")
