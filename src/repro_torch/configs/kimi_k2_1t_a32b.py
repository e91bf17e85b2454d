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

ONE_H100 = dataclasses.replace(
    CONFIG,
    name="kimi-k2-1t-a32b-1xh100",
    n_layers=2,
    moe=dataclasses.replace(CONFIG.moe, n_experts=192),
)
"""Kimi K2 cut to fit one 80 GB H100 for serving: the one cut in the zoo
that takes a width.

Every other width is the published one: d_model 7168, 64 query and 8 kv
heads of dimension 112, top-8 routing over the routed experts, 1 shared
expert, d_ff 2048, vocab 163 840, an untied head. Two keys change:

- ``n_layers`` 61 -> 2: the dense first layer (``n_dense_prefix`` 1) and
  one MoE layer, so every block kind of the published stack runs.
- ``moe.n_experts`` 384 -> 192. No depth cut fits the card: at 384
  experts the two layers alone are 19.582 G parameters, 78.33 GB in fp32
  (the 384 routed experts of d_ff 2048 are 16.9 G of them). At 192 each
  expert receives twice the published share of a batch's tokens (the
  router still picks 8 a token), so the expert GEMMs are twice as tall as
  at 384.

That leaves 11.125 G parameters (``ONE_H100.param_count()``: 11 125 230 592;
the embedding and the head 2.349 G, the routed experts 8.456 G), 44.50 GB
in fp32.
"""
