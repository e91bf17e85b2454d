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
    """Uniform random prompts ``{"tokens": [B, S] int64}`` on the
    generator's device."""
    transformer.check_supported(cfg)
    return {"tokens": torch.randint(
        0, cfg.vocab, (shape.global_batch, shape.seq_len),
        generator=generator, device=generator.device)}
