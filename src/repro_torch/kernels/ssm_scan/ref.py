"""Plain PyTorch version of the selective-scan kernel: the CPU path of
``ops.ssm_scan`` and the oracle the CUDA kernel is held to (the JAX
package's ``kernels/ssm_scan/ref.py``, a loop over time); and
``ssm_scan_exp2``, the CUDA kernel's arithmetic on the CPU, which the tests
hold to the oracle."""
from __future__ import annotations

from typing import Optional, Tuple

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


# the backward kernel (csrc/ssm_scan_bwd.cu): blocks of BWD_THREADS
# threads, a channel's states split over lanes of BWD_STATES_PER_LANE
# (REPRO_SSM_BWD_STATES_PER_LANE), and the BWD_CLUSTER blocks of a thread
# block cluster summing their dB and dC terms into one partial
BWD_THREADS = 128
BWD_STATES_PER_LANE = 4
BWD_CLUSTER = 8


def bwd_channel_block(ds: int) -> int:
    """Channels whose dB and dC terms the backward kernel sums into one
    partial at ``ds``: a cluster's blocks, each of BWD_THREADS / (lanes a
    channel) channels (256 at ds 16)."""
    width = state_bucket(ds)
    lanes = width // min(width, BWD_STATES_PER_LANE)
    return BWD_THREADS // lanes * BWD_CLUSTER


def ssm_scan_chunked_ref(u: torch.Tensor, dt: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         a: torch.Tensor, d_skip: torch.Tensor,
                         chunk: int = CHUNK):
    """``ssm_scan_ref`` that also returns the state entering each chunk of
    ``chunk`` steps, as the training forward writes it: (y [B, T, d_in], h
    [B, d_in, ds], h_chunks [B, ceil(T / chunk), d_in, ds], zero for chunk
    0). In the inputs' precision (fp32 at least), for the gradient
    checks."""
    dtype = torch.promote_types(u.dtype, torch.float32)
    u, dt, bmat, cmat, a, d_skip = (x.to(dtype) for x in (u, dt, bmat, cmat,
                                                          a, d_skip))
    bsz, t, d_in = u.shape
    h = torch.zeros((bsz, d_in, a.shape[1]), dtype=dtype, device=u.device)
    ys, chunks = [], []
    for i in range(t):
        if i % chunk == 0:
            chunks.append(h)
        h = (torch.exp(dt[:, i, :, None] * a) * h
             + (dt[:, i] * u[:, i])[..., None] * bmat[:, i, None, :])
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, i])
                  + u[:, i] * d_skip)
    return torch.stack(ys, dim=1), h, torch.stack(chunks, dim=1)


def ssm_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                     cmat: torch.Tensor, a: torch.Tensor,
                     d_skip: torch.Tensor, h_chunks: torch.Tensor,
                     dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
                     chunk: int = CHUNK):
    """The backward kernel's algorithm (``csrc/ssm_scan_bwd.cu``) in plain
    torch. Inputs as ``ssm_scan_ref``'s, ``h_chunks`` the forward's states
    entering each chunk, ``dy`` [B, T, d_in] and ``dh`` [B, d_in, ds] (None
    for zero) the cotangents of y and the final h. Returns (du, ddt, dB,
    dC, da, dd_skip) shaped as (u, dt, bmat, cmat, a, d_skip).

    Chunks last to first: each chunk's states are recomputed from its
    entering state (never by dividing by the decay), then the adjoint g
    (from dh) runs backward: g += C_t dy_t; du_t = d_skip dy_t + dt_t sum_s
    g B_t; ddt_t = sum_s g (a e_t h_{t-1} + u_t B_t); dB_t, dC_t take g
    dt_t u_t and h_t dy_t; da takes g h_{t-1} dt_t e_t; g *= e_t. As the
    kernel sums them, dB and dC join the channels of each slab of
    ``bwd_channel_block(ds)`` first and then the slabs in order, da and
    dd_skip the batch rows in order. In the inputs' precision (fp32 at
    least)."""
    dtype = torch.promote_types(u.dtype, torch.float32)
    u, dt, bmat, cmat, a, d_skip, h_chunks, dy = (
        x.to(dtype) for x in (u, dt, bmat, cmat, a, d_skip, h_chunks, dy))
    bsz, t, d_in = u.shape
    ds = a.shape[1]
    g = (torch.zeros((bsz, d_in, ds), dtype=dtype, device=u.device)
         if dh is None else dh.to(dtype).clone())
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    vb = torch.empty((bsz, t, d_in, ds), dtype=dtype, device=u.device)
    vc = torch.empty_like(vb)
    da = torch.zeros((bsz, d_in, ds), dtype=dtype, device=u.device)
    for k in reversed(range(h_chunks.shape[1])):
        t0, t1 = k * chunk, min(t, (k + 1) * chunk)
        hs = [h_chunks[:, k]]
        for i in range(t0, t1):
            hs.append(torch.exp(dt[:, i, :, None] * a) * hs[-1]
                      + (dt[:, i] * u[:, i])[..., None] * bmat[:, i, None, :])
        for i in reversed(range(t0, t1)):
            e = torch.exp(dt[:, i, :, None] * a)
            g = g + cmat[:, i, None, :] * dy[:, i, :, None]
            hp = hs[i - t0]
            geh = g * e * hp
            gb = (g * bmat[:, i, None, :]).sum(-1)
            du[:, i] = d_skip * dy[:, i] + dt[:, i] * gb
            ddt[:, i] = (geh * a).sum(-1) + u[:, i] * gb
            da = da + geh * dt[:, i, :, None]
            vb[:, i] = g * (dt[:, i] * u[:, i])[..., None]
            vc[:, i] = hs[i - t0 + 1] * dy[:, i, :, None]
            g = g * e

    def channel_slabs(x):   # [B, T, d_in, ds] -> [B, T, ds]
        width = bwd_channel_block(ds)
        acc = None
        for c0 in range(0, d_in, width):
            part = x[:, :, c0:c0 + width].sum(2)
            acc = part if acc is None else acc + part
        return acc

    def rows_in_order(x):    # [B, ...] -> [...]
        acc = x[0]
        for r in range(1, bsz):
            acc = acc + x[r]
        return acc

    return (du, ddt, channel_slabs(vb), channel_slabs(vc),
            rows_in_order(da), rows_in_order((dy * u).sum(1)))
