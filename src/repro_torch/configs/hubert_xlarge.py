"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-prediction codebook).
The mel-spectrogram + conv feature extractor is a STUB: input_specs() provides
precomputed frame embeddings (batch, frames, d_model). Encoder-only: no decode
step exists — decode_32k and long_500k are skipped (see DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    mlp="gelu",
    causal=False,
    audio_frontend=True,
    source="arXiv:2106.07447",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="hubert-xlarge-smoke",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    d_ff=256,
    vocab=96,
)

ONE_H100 = CONFIG
"""HuBERT X-Large's encoder (arXiv:2106.07447) as published, not cut: 48
bidirectional layers of d_model 1280, 16 heads of dim 80, GELU d_ff 5120, a
504-entry codebook head (the conv feature extractor is a stub: frame
embeddings arrive as inputs, as in the reference). 0.95 G parameters, 3.8
GB in fp32: it fits one 80 GB H100 whole, so ``reduced`` lists nothing.
Encoder only: no decode step."""
