"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab=256_000,
    head_dim=128,
    mlp="squared_relu",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="nemotron-4-15b-smoke",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab=512,
)
