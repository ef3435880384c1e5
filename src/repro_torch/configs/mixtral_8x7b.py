"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window attn."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    pattern=("attn_local",), window=4096,
    moe=True, n_experts=8, top_k=2, moe_d_ff=14336,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16, window=8,
                          n_experts=4, top_k=2, moe_d_ff=96,
                          dtype="float32")
