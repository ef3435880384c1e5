"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA + 256-expert MoE top-8 + shared.

61 layers: 3 leading dense-FFN layers + 58 MoE layers.  MLA dims per the
paper: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128.  MTP head
omitted (noted in DESIGN.md §Arch-applicability).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, head_dim=128,
    pattern=("attn",), n_dense_layers=3,
    moe=True, n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=160, vocab=256, head_dim=16,
                          n_dense_layers=1, n_experts=8, n_shared_experts=1,
                          top_k=2, moe_d_ff=48,
                          mla=True, q_lora_rank=32, kv_lora_rank=16,
                          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                          dtype="float32")
