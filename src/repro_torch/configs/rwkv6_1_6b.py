"""RWKV6-1.6B "Finch" [arXiv:2404.05892]: attention-free, data-dep decay."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64, rwkv_head_dim=64,
    pattern=("rwkv",),
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=32, rwkv_head_dim=32,
                          dtype="float32")
