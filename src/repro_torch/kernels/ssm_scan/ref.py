"""Plain PyTorch version of the selective-scan kernel: the CPU path of
``ops.ssm_scan`` and the oracle the CUDA kernel is held to (the JAX
package's ``kernels/ssm_scan/ref.py``, a loop over time); and
``ssm_scan_exp2``, the CUDA kernel's arithmetic on the CPU, which the tests
hold to the oracle."""
from __future__ import annotations

from typing import Tuple

import torch

# log2(e): the kernel takes exp(dt a) as exp2(dt (a log2(e))), with a
# prescaled once
LOG2E = 1.4426950408889634
# states a lane of the kernel holds and time steps it stages at once
# (csrc/ssm_scan.cu, REPRO_SSM_STATES_PER_LANE and REPRO_SSM_CHUNK)
STATES_PER_LANE = 16
CHUNK = 16


def state_bucket(ds: int) -> int:
    """The kernel's state width for ``ds``: the template bucket 4, 8, 16,
    32 or 64 it is rounded up to."""
    for width in (4, 8, 16, 32, 64):
        if 1 <= ds <= width:
            return width
    raise ValueError(f"ds={ds}: the kernel takes 1 <= ds <= 64")


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


def ssm_scan_exp2(u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic in fp32 on the CPU, for the tests: the
    decay as ``exp2(dt * (a * LOG2E))``; y_t from each lane's states
    (``STATES_PER_LANE`` of the bucket's width, zero past ds) summed in
    ascending order, the lanes' sums joined pairwise as the kernel's xor
    shuffles join them, then ``u_t * d_skip`` added. Same shapes and
    returns as ``ssm_scan_ref``."""
    f32 = torch.float32
    u32, dt32 = u.to(f32), dt.to(f32)
    b32, c32 = bmat.to(f32), cmat.to(f32)
    a2 = a.to(f32) * torch.tensor(LOG2E, dtype=f32)
    d32 = d_skip.to(f32)
    bsz, t, d_in = u.shape
    ds = a.shape[1]
    width = state_bucket(ds)
    spl = min(width, STATES_PER_LANE)
    h = torch.zeros((bsz, d_in, ds), dtype=f32, device=u.device)
    ys = []
    for i in range(t):
        u_t, dt_t = u32[:, i], dt32[:, i]
        decay = torch.exp2(dt_t[..., None] * a2)
        h = decay * h + (dt_t * u_t)[..., None] * b32[:, i, None, :]
        prod = torch.nn.functional.pad(h * c32[:, i, None, :],
                                       (0, width - ds))
        prod = prod.reshape(bsz, d_in, width // spl, spl)
        acc = torch.zeros(prod.shape[:-1], dtype=f32, device=u.device)
        for j in range(spl):
            acc = acc + prod[..., j]
        while acc.shape[-1] > 1:
            acc = acc[..., 0::2] + acc[..., 1::2]
        ys.append(acc[..., 0] + u_t * d32)
    return torch.stack(ys, dim=1).to(u.dtype), h
