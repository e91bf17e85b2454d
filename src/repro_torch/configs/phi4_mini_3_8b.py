"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    head_dim=128,
    mlp="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2412.08905",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="phi4-mini-3.8b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab=512,
)
