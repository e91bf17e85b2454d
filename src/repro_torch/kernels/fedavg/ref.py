"""Plain PyTorch versions of the aggregation and diagnostics kernels: the
CPU path of ``ops.fedavg_flat`` / ``ops.mix_rows_flat`` /
``ops.digest_div_flat`` and the oracles the CUDA kernels are held to, at a
tolerance."""
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
    [C] f32). The column mean is the kernel's: each column summed in
    ascending c, then divided by C (as the JAX kernel divides its column
    sum), so the two agree on it bitwise; a residual of a client near the
    mean is then not swamped by the last bit of a mean rounded another
    way."""
    x = x.to(torch.float32)
    colsum = x[0].clone()
    for row in x[1:]:
        colsum += row
    mean = colsum / x.shape[0]
    return x.sum(), ((x - mean) ** 2).sum(dim=1)


def mix_rows_flat_ref(w_rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w_rows: [R, K]; x: [K, N] -> [R, N] = w_rows @ x, written as an fp32
    loop over k and not as a library matrix product: from zero, each k in
    ascending order adds its rounded product, which is the kernel's
    arithmetic term for term (the two agree bitwise)."""
    w = w_rows.to(torch.float32)
    x = x.to(torch.float32)
    out = torch.zeros((w.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[1]):
        out += w[:, k:k + 1] * x[k:k + 1]
    return out
