"""Wrappers of the CUDA selective-scan kernels (``csrc/ssm_scan.cu``, the
forward, and ``csrc/ssm_scan_bwd.cu``, its gradient).

On a CUDA tensor ``ssm_scan`` launches the forward kernel (or raises).
When grad mode is on and an input requires grad it goes through
:class:`_ScanFn`, whose forward also has the kernel write the state
entering every chunk of ``ref.CHUNK`` steps and whose backward launches
the backward kernel (:func:`ssm_scan_bwd`), which recomputes each chunk's
states from them. On a CPU tensor it runs the plain version
(``ref.ssm_scan_ref``), which autograd follows. As the JAX package's
wrapper does, it hands the kernels fp32 copies of its inputs (and
contiguous ones: B_t and C_t arrive as slices of one projection), so the
inputs may be any float dtype, and autograd takes the copies back to
them; y comes back in u's dtype. Any T, d_in and d_state <= 64.

On meta tensors (the dry-run) ``ssm_scan`` returns y, the final h and,
under grad, the gradients as meta tensors of the kernels' shapes,
computes nothing and never runs the plain twin. Every call reports the
kernel's cost to the active ``launch.cost_analysis`` counters
(:func:`cost`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import CHUNK, ssm_scan_ref
from repro_torch.launch import cost_analysis

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 8 + [_I] * 4 + [_P]
# repro_ssm_scan_chunks, repro_ssm_scan_bwd
_SIGNATURE_CHUNKS = [_P] * 9 + [_I] * 5 + [_P]
_SIGNATURE_BWD = [_P] * 16 + [_I] * 5 + [_P]
MAX_D_STATE = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    if lib.repro_ssm_scan.argtypes is None:
        lib.repro_ssm_scan.argtypes = _SIGNATURE
        lib.repro_ssm_scan_chunks.argtypes = _SIGNATURE_CHUNKS
        for fn in (lib.repro_ssm_scan, lib.repro_ssm_scan_chunks):
            fn.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    if lib.repro_ssm_scan_bwd.argtypes is None:
        lib.repro_ssm_scan_bwd.argtypes = _SIGNATURE_BWD
        lib.repro_ssm_scan_bwd.restype = ctypes.c_int
        lib.repro_ssm_scan_bwd_workspace.argtypes = [_I] * 4
        lib.repro_ssm_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def cost(bsz: int, t: int, d_in: int, ds: int, *, chunks: bool = False,
         backward: bool = False, dh: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one call on fp32 inputs, n = B·T·d_in. Forward:
    5·ds + 3 flops a (row, step, channel) (dt·a, the state's and the
    output's multiply-adds; dt·u, u·d_skip, the add); u, dt, B_t, C_t, a
    and d_skip read, y and the final h written once, and with ``chunks``
    the state entering each chunk of ``ref.CHUNK`` steps. Backward: twice
    the forward's flops (each chunk's states recomputed, then the reverse
    sweep); the forward's inputs, its chunk states, dy (and with ``dh``
    the final h's cotangent) read, the six gradients written once."""
    n, states = bsz * t * d_in, bsz * d_in * ds
    inputs = 2 * n + 2 * bsz * t * ds + d_in * ds + d_in
    chunk_states = bsz * -(-t // CHUNK) * d_in * ds
    flops = 5 * n * ds + 3 * n
    if backward:
        words = 2 * inputs + chunk_states + n + (states if dh else 0)
        return float(2 * flops), float(4 * words)
    words = inputs + n + states + (chunk_states if chunks else 0)
    return float(flops), float(4 * words)


def _launch(u, dt, bmat, cmat, a, d_skip, chunks: bool):
    """The forward kernel on fp32 contiguous CUDA inputs: (y, final h,
    the states entering each chunk or None)."""
    bsz, t, d_in = u.shape
    ds = a.shape[1]
    y = torch.empty((bsz, t, d_in), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, d_in, ds), dtype=torch.float32, device=u.device)
    h_chunks = (torch.empty((bsz, -(-t // CHUNK), d_in, ds),
                            dtype=torch.float32, device=u.device)
                if chunks else None)
    cost_analysis.report_kernel("ssm_scan", lambda: cost(
        bsz, t, d_in, ds, chunks=chunks))
    if u.device.type == "meta":
        return y, h, h_chunks
    lib = _lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    ptrs = [x.data_ptr() for x in (u, dt, bmat, cmat, a, d_skip, y, h)]
    if chunks:
        err = lib.repro_ssm_scan_chunks(*ptrs, h_chunks.data_ptr(), CHUNK,
                                        bsz, t, d_in, ds, stream)
    else:
        err = lib.repro_ssm_scan(*ptrs, bsz, t, d_in, ds, stream)
    _build.check(lib, err, "ssm_scan")
    ssm_scan.launches += 1
    return y, h, h_chunks


def ssm_scan_bwd(u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh=None):
    """Launch the backward kernel (one call: the reverse sweep, then the
    fixed-order sums of its partials) on fp32 contiguous CUDA tensors: the
    forward's inputs, its chunk states, the cotangents of y and (None for
    zero) of the final h. Returns (du, ddt, dB, dC, da, dd_skip). Counts one
    launch a call (``ssm_scan_bwd.launches``)."""
    bsz, t, d_in = u.shape
    ds = a.shape[1]
    grads = [torch.empty(x.shape, dtype=torch.float32, device=u.device)
             for x in (u, dt, bmat, cmat, a, d_skip)]
    dy = dy.to(torch.float32).contiguous()
    dh = None if dh is None else dh.to(torch.float32).contiguous()
    cost_analysis.report_kernel("ssm_scan_bwd", lambda: cost(
        bsz, t, d_in, ds, backward=True, dh=dh is not None))
    if u.device.type == "meta":
        return tuple(grads)
    lib = _lib_bwd()
    work = torch.empty(lib.repro_ssm_scan_bwd_workspace(bsz, t, d_in, ds),
                       dtype=torch.float32, device=u.device)
    err = lib.repro_ssm_scan_bwd(
        *(x.data_ptr() for x in (u, dt, bmat, cmat, a, d_skip, h_chunks,
                                 dy)),
        None if dh is None else dh.data_ptr(),
        *(g.data_ptr() for g in grads), work.data_ptr(), CHUNK, bsz, t,
        d_in, ds, torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return tuple(grads)


ssm_scan_bwd.launches = 0


class _ScanFn(torch.autograd.Function):
    """The kernels under autograd, on fp32 contiguous inputs: ``forward``
    launches the forward with its chunk states and saves them with the
    inputs; ``backward`` takes the cotangents of y and of the final h
    (either may be None) and launches :func:`ssm_scan_bwd`."""

    @staticmethod
    def forward(ctx, u, dt, bmat, cmat, a, d_skip):
        y, h, h_chunks = _launch(u, dt, bmat, cmat, a, d_skip, chunks=True)
        ctx.save_for_backward(u, dt, bmat, cmat, a, d_skip, h_chunks)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, bmat, cmat, a, d_skip, h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        return ssm_scan_bwd(u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: [B, T, d_in]; bmat, cmat: [B, T, ds]; a: [d_in, ds]; d_skip:
    [d_in]. Returns (y [B, T, d_in] in u's dtype, final h [B, d_in, ds]
    fp32): h <- exp(dt_t a) h + (dt_t u_t) B_t, y_t = h C_t + u_t d_skip."""
    if u.dim() != 3 or dt.shape != u.shape or a.dim() != 2:
        raise ValueError(f"ssm_scan: u and dt must be [B, T, d_in] and a "
                         f"[d_in, ds]: u={tuple(u.shape)} "
                         f"dt={tuple(dt.shape)} a={tuple(a.shape)}")
    bsz, t, d_in = u.shape
    ds = a.shape[1]
    if bmat.shape != (bsz, t, ds) or cmat.shape != (bsz, t, ds) \
            or a.shape[0] != d_in or d_skip.shape != (d_in,):
        raise ValueError(f"ssm_scan: bmat/cmat must be [{bsz}, {t}, {ds}], "
                         f"a [{d_in}, {ds}], d_skip [{d_in}]: "
                         f"bmat={tuple(bmat.shape)} cmat={tuple(cmat.shape)} "
                         f"a={tuple(a.shape)} d_skip={tuple(d_skip.shape)}")
    if not (t >= 1 and 1 <= ds <= MAX_D_STATE and 1 <= bsz <= 65535):
        raise ValueError(f"ssm_scan: T={t}, ds={ds}, B={bsz}: the kernel "
                         f"takes T >= 1, ds <= {MAX_D_STATE}, B <= 65535")
    devices = {x.device for x in (u, dt, bmat, cmat, a, d_skip)}
    if len(devices) != 1 or u.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssm_scan: inputs must lie on one cpu, cuda or "
                         f"meta device, not {devices}")
    if u.device.type == "cpu":
        with cost_analysis.kernel("ssm_scan",
                                  lambda: cost(bsz, t, d_in, ds)):
            return ssm_scan_ref(u, dt, bmat, cmat, a, d_skip)
    f32 = [x.to(torch.float32).contiguous()
           for x in (u, dt, bmat, cmat, a, d_skip)]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (u, dt, bmat, cmat, a, d_skip)):
        y, h = _ScanFn.apply(*f32)
    else:
        y, h, _ = _launch(*f32, chunks=False)
    return y.to(u.dtype), h


ssm_scan.launches = 0
