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

ONE_H100 = dataclasses.replace(
    CONFIG,
    name="deepseek-v2-236b-1xh100",
    n_layers=4,
)
"""DeepSeek-V2 (arXiv:2405.04434) cut to fit one 80 GB H100 for serving.

Every width is the published one: d_model 5120, 128 heads of dimension
128, MLA with kv_lora 512, q_lora 1536 and a decoupled rope dim of 64,
160 routed experts (top-6) and 2 shared experts of d_ff 1536 each, vocab
102400. One key changes:

- ``n_layers`` 60 -> 4: the dense first layer (``n_dense_prefix`` 1) and
  three MoE layers, so every block kind of the published stack runs.

That leaves 13.14 G parameters (``ONE_H100.param_count()``: embedding
and head 1.05 G, four MLA mixers at 0.149 G, three MoE layers at 3.823 G
each, of which the routed experts are 3.775 G), 52.6 GB in fp32.
"""
