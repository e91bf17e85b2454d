"""Plain PyTorch version of the selective-scan kernel: the CPU path of
``ops.ssm_scan`` and the oracle the CUDA kernel is held to (the JAX
package's ``kernels/ssm_scan/ref.py``, a loop over time)."""
from __future__ import annotations

from typing import Tuple

import torch


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: [B, T, d_in]; bmat, cmat: [B, T, ds]; a: [d_in, ds]; d_skip:
    [d_in]. Returns (y [B, T, d_in] in u's dtype, final h [B, d_in, ds] in
    fp32): h <- exp(dt_t a) h + (dt_t u_t) B_t, y_t = h C_t + u_t d_skip."""
    f32 = torch.float32
    u32, dt32 = u.to(f32), dt.to(f32)
    b32, c32 = bmat.to(f32), cmat.to(f32)
    a32, d32 = a.to(f32), d_skip.to(f32)
    bsz, t, d_in = u.shape
    h = torch.zeros((bsz, d_in, a.shape[1]), dtype=f32, device=u.device)
    ys = []
    for i in range(t):
        u_t, dt_t = u32[:, i], dt32[:, i]
        da = torch.exp(dt_t[..., None] * a32)
        h = da * h + (dt_t * u_t)[..., None] * b32[:, i, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c32[:, i]) + u_t * d32)
    return torch.stack(ys, dim=1).to(u.dtype), h
