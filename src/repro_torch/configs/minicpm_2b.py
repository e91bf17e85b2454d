"""minicpm-2b [dense] — WSD schedule, llama-like arch [arXiv:2404.06395].

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
The WSD (warmup-stable-decay) schedule lives in repro.training.optim and is
selected by this config's train recipe.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122_753,
    head_dim=64,
    mlp="swiglu",
    tie_embeddings=True,
    source="arXiv:2404.06395",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="minicpm-2b-smoke",
    n_layers=2,
    d_model=144,
    n_heads=4,
    n_kv_heads=4,
    head_dim=36,
    d_ff=288,
    vocab=512,
)

ONE_H100 = CONFIG
"""MiniCPM-2B (arXiv:2404.06395) as published, not cut: 40 layers of
d_model 2304, 36 heads of dimension 64 (MHA: 36 kv heads), a SwiGLU MLP
of d_ff 5760, vocab 122 753 and the head tied to the embedding. No key
changes, so the whole model serves on one 80 GB H100.

That is 2.725 G parameters (``ONE_H100.param_count()``: 2 724 880 896;
the tied embedding 0.283 G, each layer 0.0610 G), 10.90 GB in fp32.
"""
