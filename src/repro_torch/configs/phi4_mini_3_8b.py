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

ONE_H100 = dataclasses.replace(
    CONFIG,
    name="phi4-mini-3.8b-1xh100",
    n_layers=2,
)
"""phi4-mini-3.8B (arXiv:2412.08905) cut in depth to train on one 80 GB
H100 by BLADE-FL rounds.

Every width is the published one: d_model 3072, 24 query heads and 8 kv
heads of dimension 128, SwiGLU d_ff 8192, vocab 200 064 with the head
tied to the embedding. One key changes:

- ``n_layers`` 32 -> 2. A round holds each client's carried and new
  params and its gradient (three copies), four clients and the lazy
  client's noise: the 32-layer 3.84 G parameters would take 184 GB at
  four clients.

That leaves 0.816 G parameters (``ONE_H100.param_count()``: the tied
embedding 0.615 G, two layers of 0.101 G: attention 0.025 G, SwiGLU
0.075 G), 3.26 GB a client in fp32; four clients x (carried, new, grad)
take 39 GB, the noise table of one lazy client at K = 2 6.5 GB.
"""
