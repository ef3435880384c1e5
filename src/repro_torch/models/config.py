"""Unified model configuration covering all ten assigned architectures.

One dataclass parameterizes the whole zoo: dense GQA transformers, local/
global mixed attention (gemma3), sliding-window (mixtral), QKV-bias (qwen2),
cross-attention VLM backbones (llama-3.2-vision), audio-codebook decoders
(musicgen), MoE (mixtral / deepseek-v3 with MLA), RG-LRU hybrids
(recurrentgemma) and RWKV6.  Per-layer heterogeneity is expressed through a
*pattern*: the layer stack is a scanned sequence of groups, each group being a
fixed tuple of block kinds (see models/model.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

BlockKind = Literal[
    "attn",        # self-attention block (global or windowed via window)
    "attn_local",  # self-attention with sliding window
    "cross",       # self-attn + cross-attn (VLM layers)
    "rglru",       # Griffin recurrent block
    "rwkv",        # RWKV6 time-mix + channel-mix
]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 => d_model // n_heads

    # Attention structure
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                      # sliding window for attn_local (0=global)
    logit_softcap: float = 0.0           # gemma-style attn logit soft-capping

    # Layer pattern: scanned groups + unrolled tail.
    # pattern: tuple of BlockKind applied per scan step; n_groups * len(pattern)
    # + len(tail) must equal n_layers.
    pattern: tuple[str, ...] = ("attn",)
    tail: tuple[str, ...] = ()

    # MLP
    mlp_act: str = "silu"                # silu|gelu (gated)

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                    # expert hidden dim (deepseek: 2048)
    n_dense_layers: int = 0              # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # RG-LRU (recurrentgemma / griffin)
    lru_width: int = 0
    conv_width: int = 4

    # RWKV6
    rwkv_head_dim: int = 64

    # Modality frontends (stubs: precomputed embeddings per the assignment)
    n_codebooks: int = 0                 # musicgen: 4
    cross_attn_tokens: int = 0           # vlm: number of vision tokens
    cross_attn_dim: int = 0              # vlm: vision embedding dim

    # Numerics / training
    softmax_f32: bool = True        # f32 attention logits (bf16 = perf knob)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # Remat (the paper's technique): policy selected by the DTR planner.
    remat: str = "none"                  # none|dtr|full|names
    remat_budget_frac: float = 0.5       # fraction of per-device HBM for acts

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        n_pattern = len(self.pattern)
        body = self.n_layers - len(self.tail) - self.n_dense_layers
        assert body % n_pattern == 0, (
            f"{self.name}: {body} body layers not divisible by pattern "
            f"{self.pattern}")

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.tail) - self.n_dense_layers) \
            // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------
    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        kinds: list[str] = []
        kinds += list(self.pattern) * self.n_groups
        kinds += list(self.tail)
        kinds = ["attn"] * self.n_dense_layers + kinds

        for kind in kinds:
            total += 2 * d  # norms
            if kind in ("attn", "attn_local", "cross"):
                if self.mla:
                    qk_head = self.qk_nope_dim + self.qk_rope_dim
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * h * qk_head
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * h * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += h * self.v_head_dim * d
                else:
                    total += d * h * hd + 2 * d * kv * hd + h * hd * d
                if kind == "cross":
                    total += (d * h * hd + 2 * self.cross_attn_dim * kv * hd
                              + h * hd * d + d)
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * self.conv_width + 3 * w + w * d
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,out
                total += 6 * d * 64         # lora mixers (approx)
                total += 2 * d * f // 2     # channel mix (r,k,v)
            # FFN
            if kind in ("attn", "attn_local", "cross"):
                is_moe_layer = self.moe
                if is_moe_layer:
                    total += d * self.n_experts  # router
                    total += self.n_experts * 3 * d * self.moe_d_ff
                    total += self.n_shared_experts * 3 * d * self.moe_d_ff
                else:
                    total += 3 * d * f
        # deepseek: leading dense layers use d_ff, already counted via moe
        # approximation; close enough for roofline purposes.
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_layers = self.n_layers - self.n_dense_layers
        all_expert = moe_layers * self.n_experts * 3 * d * self.moe_d_ff
        active_expert = moe_layers * self.top_k * 3 * d * self.moe_d_ff
        return int(full - all_expert + active_expert)
