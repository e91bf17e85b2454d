"""Model init and prompt batches for the LM zoo (the serving part of the
JAX package's ``models/registry.py``).

Both draw from an explicit ``torch.Generator`` on the target device: at
full width the weights are drawn on the card, never copied up from the
host. The draws differ from ``jax.random``'s; tests carry the reference's
params across with ``weights.lm_params_from_jax`` instead.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict[str, Any]:
    return transformer.init_lm(generator, cfg, dtype)


def make_prefill_batch(generator: torch.Generator, cfg: ModelConfig,
                       shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """A prompt batch of S = ``shape.seq_len`` positions on the generator's
    device, as the reference's ``make_prefill_batch`` lays it out: for a
    VLM ``{"patches": [B, P, D] ~ N(0, 1), "tokens": [B, S - P]}`` (P =
    ``cfg.vlm_prefix_len``; ``ValueError`` unless S > P), for the audio
    encoder ``{"frames": [B, S, D] ~ N(0, 1)}``, else ``{"tokens": [B,
    S]}``; tokens uniform int64."""
    b, s, dev = shape.global_batch, shape.seq_len, generator.device

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=generator,
                             device=dev)

    if cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        if s <= p:
            raise ValueError(f"{cfg.name}: a prompt of {s} positions leaves "
                             f"no text after the {p} image patches")
        return {"patches": torch.randn((b, p, cfg.d_model),
                                       generator=generator, device=dev),
                "tokens": tokens(s - p)}
    if cfg.audio_frontend:
        return {"frames": torch.randn((b, s, cfg.d_model),
                                      generator=generator, device=dev)}
    return {"tokens": tokens(s)}
