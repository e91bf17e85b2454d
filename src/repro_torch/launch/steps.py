"""The mesh-free part of the JAX package's ``launch/steps.py``: the arch
variant a shape runs, the shapes an arch skips, and the BLADE-FL round
configuration of an (arch, shape, client count) cell.

The reference's ``build_train_step``, ``build_prefill_step`` and
``build_decode_step`` place a step on a device mesh with its shardings;
they come with the port's multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import rounds

SLIDING_WINDOW_LONG = 8192  # dense archs x long_500k: windowed-attention variant


def resolve_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The arch's variant for a shape: a causal full-attention arch runs
    long_500k with the sliding-window variant."""
    if shape.name == "long_500k" and cfg.causal and not cfg.subquadratic:
        return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.kind == "decode" and not cfg.has_decode:
        return "encoder-only architecture: no autoregressive decode step"
    return None


def round_spec_for(cfg: ModelConfig, shape: ShapeConfig, n_clients: int, *,
                   tau: int = 2, mine_attempts: int = 1024
                   ) -> rounds.RoundSpec:
    """The round of a training cell at ``n_clients`` clients on one device:
    the reference's ``round_spec_for`` without FSDP axes (microbatches of
    8 samples a client, so ``max(1, m // 8)`` of them for m =
    ``global_batch / n_clients``; one lazy client in 8; sigma2 1e-4;
    difficulty 8; no global-loss eval)."""
    m = shape.global_batch // n_clients
    return rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=1e-3,
        n_lazy=max(n_clients // 8, 0), sigma2=1e-4,
        mine_attempts=mine_attempts, difficulty_bits=8,
        microbatches=max(1, m // 8), eval_global_loss=False)
