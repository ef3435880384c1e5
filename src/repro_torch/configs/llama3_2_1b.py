"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: small llama3 dense LM."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=64,
    pattern=("attn",), rope_theta=500_000.0, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
                          d_ff=160, vocab=256, head_dim=8, dtype="float32")
