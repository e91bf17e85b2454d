"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434].

60L d_model=5120 128H d_ff=1536 (per-expert) vocab=102400. MLA with
kv_lora_rank=512, q_lora_rank=1536, decoupled rope dim 64; first layer dense.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head keys reconstructed from the shared latent
    d_ff=1536,
    vocab=102_400,
    head_dim=128,
    mlp="swiglu",
    n_dense_prefix=1,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff=1536, every=1),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64),
    source="arXiv:2405.04434",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="deepseek-v2-236b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab=512,
    n_dense_prefix=1,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff=128, every=1),
    mla=MLAConfig(kv_lora=64, q_lora=0, rope_dim=16),
)
