"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small dense LM."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, head_dim=64,
    pattern=("attn",), rope_theta=10_000.0, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          dtype="float32")
