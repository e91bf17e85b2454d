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

ONE_H100 = dataclasses.replace(
    CONFIG,
    name="nemotron-4-15b-1xh100",
    n_layers=16,
)
"""Nemotron-4-15B (arXiv:2402.16819) cut to fit one 80 GB H100 for
serving.

Every width is the published one: d_model 6144, 48 query and 8 kv heads
of dimension 128, a squared-ReLU MLP of d_ff 24 576, vocab 256 000 and an
untied head. One key changes:

- ``n_layers`` 32 -> 16. The published model is 15.628 G parameters,
  62.51 GB in fp32: that would leave under 17 GB of the card for the
  stacked leaves' draw, the caches and the activations. The attention's
  shapes (and so the flash kernel's) do not depend on the depth.

That leaves 9.387 G parameters (``ONE_H100.param_count()``: 9 387 055 104;
the embedding and the head 3.146 G, each layer 0.390 G), 37.55 GB in
fp32.
"""
