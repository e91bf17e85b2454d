"""Plain PyTorch versions of the fused aggregation and diagnostics kernels:
the CPU path of ``ops.fedavg_flat`` / ``ops.digest_div_flat`` and the
oracles the CUDA kernels are held to, at a tolerance."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def fedavg_flat_ref(x: torch.Tensor, weights: torch.Tensor,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [C, N]; weights: [C] normalised; noise: [C, N] or None. Every
    row of the result is the weighted client mean (+ that row's noise)."""
    agg = weights.to(torch.float32) @ x.to(torch.float32)
    out = agg.expand(x.shape)
    if noise is not None:
        out = out + noise.to(torch.float32)
    return out.to(x.dtype).contiguous()


def digest_div_flat_ref(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [C, N] -> (leaf sum, 0-d f32; per-client sum_n (x - colmean)^2,
    [C] f32)."""
    x = x.to(torch.float32)
    mean = x.mean(dim=0, keepdim=True)
    return x.sum(), ((x - mean) ** 2).sum(dim=1)
