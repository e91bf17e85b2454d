"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own up/down projections, there is no separate FFN sub-layer.
Block layout: period of 4 = 3 mLSTM + 1 sLSTM (xLSTM[3:1] style).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    mlp="gelu",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0, conv_width=4),
    source="arXiv:2405.04517",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="xlstm-125m-smoke",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    vocab=512,
    block_pattern=("mlstm", "slstm"),
)

ONE_H100 = CONFIG
"""xLSTM-125M (arXiv:2405.04517) as published, not cut: 12 layers of d_model
768 (three periods of 3 mLSTM + 1 sLSTM block, 4 heads of 384 after the
2x up-projection), vocab 50304, 0.205 G parameters (0.82 GB in fp32),
so the whole model fits one 80 GB H100 and ``reduced`` lists nothing."""
