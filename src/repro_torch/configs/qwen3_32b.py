"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family scaled].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25_600,
    vocab=151_936,
    head_dim=128,
    mlp="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-32b-smoke",
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
    name="qwen3-32b-1xh100",
    n_layers=2,
)
"""Qwen3-32B cut to fit one 80 GB H100.

Every width is the published one: d_model 5120, 64 query and 8 kv heads
of dimension 128 with qk-norm, a SwiGLU MLP of d_ff 25 600, vocab
151 936 and an untied head. One key changes:

- ``n_layers`` 64 -> 2.

That leaves 2.531 G parameters (``ONE_H100.param_count()``: the
embedding and the head 1.556 G, each layer 0.487 G), 10.12 GB in fp32;
one layer (``n_layers`` 1) is 2.043 G, 8.17 GB.
"""
