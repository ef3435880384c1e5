"""RecurrentGemma-2B [arXiv:2402.19427]: Griffin — RG-LRU + local attn 1:2.

26 layers = 8 scan groups x (rec, rec, attn_local) + 2 rec tail.
Local attention window 2048.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    pattern=("rglru", "rglru", "attn_local"),
    tail=("rglru", "rglru"),
    window=2048, lru_width=2560, conv_width=4,
    rope_theta=10_000.0, tie_embeddings=True, mlp_act="gelu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=2, n_kv_heads=1,
                          d_ff=128, vocab=256, head_dim=32, window=8,
                          lru_width=64,
                          pattern=("rglru", "rglru", "attn_local"),
                          tail=("rglru", "rglru"), dtype="float32")
