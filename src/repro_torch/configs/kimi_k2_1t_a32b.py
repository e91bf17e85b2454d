"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384 experts top-8 + 1 shared, first layer dense.
"""
import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163_840,
    head_dim=112,  # 7168 / 64
    mlp="swiglu",
    n_dense_prefix=1,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_ff=2048, every=1),
    source="arXiv:2501.kimi2",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="kimi-k2-1t-a32b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    head_dim=64,
    d_ff=128,
    vocab=512,
    n_dense_prefix=1,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff=128, every=1),
)
