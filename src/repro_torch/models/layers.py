"""Shared neural-net building blocks: plain functions over dicts of
tensors, in the JAX package's layout (``w [in, out]``, ``x @ w``)."""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """[in_dim, out_dim] weights ~ N(0, scale^2), scale = in_dim**-0.5 by
    default; drawn on the generator's device."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean negative log-likelihood over the batch axis (the one before the
    class axis): logits [..., B, V], labels [..., B] int -> [...]. For a
    single model's [B, V] logits it is the JAX package's scalar loss; for
    client-stacked [C, B, V] logits it is the per-client loss [C]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)
