"""Wrapper of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

On a CUDA tensor ``ssm_scan`` launches the kernel (or raises: also when
grad mode is on and an input requires grad, since the kernel has no
backward yet, ``_build.refuse_grad``); on a CPU tensor it runs the plain
version (``ref.ssm_scan_ref``), which autograd follows. As the JAX
package's wrapper does, it hands the kernel fp32 copies of its inputs
(and contiguous ones: B_t and C_t arrive as slices of one projection), so
the inputs may be any float dtype; y comes back in u's dtype. Any T, d_in
and d_state <= 64.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 8 + [_I] * 4 + [_P]
MAX_D_STATE = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


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
    if len(devices) != 1 or u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: inputs must lie on one cpu or cuda "
                         f"device, not {devices}")
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, bmat, cmat, a, d_skip)
    _build.refuse_grad("ssm_scan", u, dt, bmat, cmat, a, d_skip)
    f32 = [x.to(torch.float32).contiguous()
           for x in (u, dt, bmat, cmat, a, d_skip)]
    y = torch.empty((bsz, t, d_in), dtype=torch.float32, device=u.device)
    h = torch.empty((bsz, d_in, ds), dtype=torch.float32, device=u.device)
    lib = _lib()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.repro_ssm_scan(*(x.data_ptr() for x in f32), y.data_ptr(),
                             h.data_ptr(), bsz, t, d_in, ds, stream)
    _build.check(lib, err, "ssm_scan")
    ssm_scan.launches += 1
    return y.to(u.dtype), h


ssm_scan.launches = 0
