"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 blocks: 7 Mamba + 1 attention (attn at index 3, Jamba-style);
MoE MLP on every 2nd layer, dense MLP otherwise.
"""
import dataclasses

from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab=65_536,
    head_dim=128,
    mlp="swiglu",
    block_pattern=("ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm", "ssm"),
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff=24_576, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="jamba-1.5-large-398b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab=512,
    block_pattern=("ssm", "attn"),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff=256, every=2),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
)

ONE_H100 = dataclasses.replace(
    CONFIG,
    name="jamba-1.5-large-398b-1xh100",
    n_layers=8,
    moe=None,
)
"""Jamba-1.5-Large (arXiv:2403.19887) cut to fit one 80 GB H100 for serving.

Every width is the published one: d_model 8192, 64 query heads and 8 kv
heads of dimension 128, SwiGLU d_ff 24576, vocab 65536, Mamba d_state 16,
d_conv 4, expand 2 (d_in 16384, dt_rank 512). Two keys change:

- ``n_layers`` 72 -> 8: one whole period of the published pattern (three
  Mamba layers, one attention layer, four Mamba layers), so the 7:1 ratio
  of Mamba to attention stays the published one.
- ``moe`` -> None: the 16-expert top-2 MoE of every 2nd layer becomes the
  dense SwiGLU MLP of the same d_ff, the block ``transformer._init_block``
  builds without MoE. Four MoE layers alone would be 38.7 G parameters
  (155 GB in fp32), twice the card's memory.

That leaves about 9.0 G parameters (``ONE_H100.param_count()``: embedding
and head 1.07 G, seven Mamba mixers at 0.420 G, attention 0.151 G, eight
MLPs at 0.604 G), 36.0 GB in fp32.
"""
