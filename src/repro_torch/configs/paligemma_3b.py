"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1 = MQA) d_ff=16384 vocab=257216.
SigLIP vision tower + projector are STUBS: input_specs() provides 256
precomputed patch embeddings of shape (batch, 256, d_model); the gemma-style
decoder (built here in full) consumes them with prefix-LM attention.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16_384,
    vocab=257_216,
    head_dim=256,
    mlp="geglu",
    tie_embeddings=True,
    vlm_prefix_len=256,
    source="arXiv:2407.07726",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="paligemma-3b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=1,
    head_dim=64,
    d_ff=256,
    vocab=512,
    vlm_prefix_len=16,
)

ONE_H100 = CONFIG
"""PaliGemma-3B's decoder (arXiv:2407.07726) as published, not cut: 18 layers
of d_model 2048, 8 query heads over 1 kv head of dim 256, GeGLU d_ff 16384,
vocab 257216 tied, a 256-patch image prefix under the prefix-LM mask (the
SigLIP tower is a stub: patch embeddings arrive as inputs, as in the
reference). 2.51 G parameters, 10.0 GB in fp32: it fits one 80 GB H100
whole, so ``reduced`` lists nothing."""
