"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``,
the forward, and ``csrc/flash_attention_bwd.cu``, its gradient).

``flash_attention`` takes the TPU kernel's ``[B, H, S, D]`` layout with kv
already at H heads; ``mha`` takes the model's ``[B, S, H, D]`` layout with
kv at ``Hkv`` heads (GQA). On a CUDA tensor both launch the forward kernel
(or raise), reading q, k and v through their strides: ``mha`` needs
neither a transpose nor a repeat of kv. When grad mode is on and an input
requires grad they go through :class:`_FlashFn`, whose forward also has
the kernel write each row's logsumexp and whose backward launches the
backward kernel (:func:`flash_attention_bwd`), fp32 only. On a CPU tensor
they run the plain version (``ref.attention_ref``, ``ref.mha_ref``: the
JAX package's transposes and ``repeat`` of kv around it), which autograd
follows. Both take any S >= 1 and any head dim D <= 256 that is a multiple
of 4; fp32 or bf16 (fp32 under grad), fp32 inside; the causal, window and
prefix-LM masks (``ref.keep_mask``; the TPU kernel has no prefix form,
the JAX model builds that mask in ``attention.build_mask``). The forward
computes both products on the tensor cores in 3xTF32, which holds the
fp32 tolerance; ``ref.attention_tf32`` emulates that arithmetic on the CPU
for the tests. The backward runs its five products the same way
(``ref.attention_bwd_ref`` is its algorithm in plain torch,
``ref.attention_bwd_tf32`` its 3xTF32 arithmetic).

On meta tensors (the dry-run, ``launch/dryrun.py``) every entry point
returns the kernel's outputs (the lse too, and under grad the gradients)
as meta tensors of their shapes and dtypes, computes nothing and never
runs the plain twin. Every call reports the kernel's cost to the active
``launch.cost_analysis`` counters (:func:`cost`): 4·D flops a kept (row,
key) pair forward, 10·D backward, the pairs the masks skip at the same
rate as ``attention_masked_flops``, its operands read and its outputs
written once.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref
from repro_torch.launch import cost_analysis

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# repro_flash_attention_lse (the serving entry takes the same less lse)
_SIGNATURE = [_P] * 5 + [_I] * 6 + [_L] * 12 + [ctypes.c_float, _I, _I, _I,
                                                _P]
_SIGNATURE_BWD = [_P] * 10 + [_I] * 5 + [_L] * 24 + [ctypes.c_float, _I, _I,
                                                     _I, _P]
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.repro_flash_attention.argtypes is None:
        lib.repro_flash_attention.argtypes = _SIGNATURE[:4] + _SIGNATURE[5:]
        lib.repro_flash_attention_lse.argtypes = _SIGNATURE
        for fn in (lib.repro_flash_attention, lib.repro_flash_attention_lse):
            fn.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE_BWD
        fn.restype = ctypes.c_int
        lib.repro_flash_attention_bwd_workspace.argtypes = [_I] * 5
        lib.repro_flash_attention_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel's limits, held on every device so that a shape behaves
    the same on the CPU and on the card."""
    if k.shape != v.shape or q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k/v must be 4-D with k.shape == v.shape: "
                         f"q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    d = q.shape[-1]
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 4 "
                         f"up to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {_DTYPES}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) \
            or q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"q/k/v must lie on one cpu, cuda or meta device: "
                         f"{q.device}, {k.device}, {v.device}")


def _prefix(prefix_len: int, seq: int) -> int:
    """The prefix length as the kernel's int takes it, in [0, S]: a prefix
    that covers the sequence is the whole square, and one of 0 or less
    none, on both devices."""
    return max(0, min(int(prefix_len), seq))


def kept_pairs(s: int, *, causal: bool, window: int, prefix_len: int
               ) -> int:
    """The (row, key) pairs of one [S, S] head that ``ref.keep_mask``
    keeps."""
    i = np.arange(s, dtype=np.int64)
    prefix = _prefix(prefix_len, s)
    if causal:
        hi = np.where(i < prefix, prefix, i + 1)
    else:
        hi = np.full(s, s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo, 0, None).sum())


def cost(b: int, s: int, h: int, hkv: int, d: int, itemsize: int, *,
         causal: bool, window: int, prefix_len: int, backward: bool = False,
         lse: bool = False) -> Tuple[float, float, float]:
    """(flops, bytes, masked flops) of one call: 4·D flops a kept pair
    forward (QK^T and PV), 10·D backward (S, dP, dV, dK, dQ), the skipped
    pairs at the same rate; q, k, v read and o written once forward (and
    the fp32 lse with ``lse``), and backward q, k, v, o, dO and the lse
    read and dq, dk, dv (fp32) written once."""
    kept = kept_pairs(s, causal=causal, window=window, prefix_len=prefix_len)
    rate = (10 if backward else 4) * d * b * h
    q_bytes, kv_bytes = b * s * h * d * itemsize, b * s * hkv * d * itemsize
    if backward:
        nbytes = (3 * q_bytes + 2 * kv_bytes + 4 * b * h * s
                  + 4 * b * s * (h + 2 * hkv) * d)
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + (4 * b * h * s if lse else 0)
    return (float(rate * kept), float(nbytes),
            float(rate * (s * s - kept)))


def _d_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _launch(q, k, v, out, *, seq_axis: int, head_axis: int, causal: bool,
            window: int, scale: float, prefix_len: int,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on 4-D q, k, v, out whose axes are (batch,
    ``seq_axis``, ``head_axis``, dim) with a head_dim stride of 1; with
    ``lse`` (contiguous fp32 [B, H, S]) it also writes each row's
    logsumexp."""
    q, k, v = _d_contiguous(q), _d_contiguous(k), _d_contiguous(v)
    b, s, h, hkv, d = (q.shape[0], q.shape[seq_axis], q.shape[head_axis],
                       k.shape[head_axis], q.shape[-1])
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h}: the kernel's grid "
                         "takes at most 65535")
    cost_analysis.report_kernel("flash_attention", lambda: cost(
        b, s, h, hkv, d, q.element_size(), causal=causal, window=window,
        prefix_len=prefix_len, lse=lse is not None))
    if q.device.type == "meta":
        return out

    def strides(x):
        return x.stride(0), x.stride(seq_axis), x.stride(head_axis)

    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (int(q.dtype == torch.bfloat16), b, h, hkv, s, d, *strides(q),
              *strides(k), *strides(v), *strides(out), scale, int(causal),
              int(window), _prefix(prefix_len, s), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is None:
        err = lib.repro_flash_attention(*ptrs, *common)
    else:
        err = lib.repro_flash_attention_lse(*ptrs, lse.data_ptr(), *common)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


def _forward_lse(q, k, v, *, seq_axis: int, head_axis: int, causal: bool,
                 window: int, scale: float, prefix_len: int):
    """The training forward on the card: (out in q's layout, lse [B, H,
    S] fp32)."""
    b, s, h = q.shape[0], q.shape[seq_axis], q.shape[head_axis]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, seq_axis=seq_axis, head_axis=head_axis,
            causal=causal, window=window, scale=scale, prefix_len=prefix_len,
            lse=lse)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, dout, *, seq_axis: int,
                        head_axis: int, causal: bool, window: int,
                        scale: float, prefix_len: int):
    """Launch the backward kernel (one call: the rows' dO . O, the
    kv-tile-major dK/dV pass, under GQA the sum of each group's heads, the
    q-tile-major dQ pass; ``launches_a_call`` of them) on fp32 CUDA
    tensors in the layout (batch, ``seq_axis``, ``head_axis``, dim): q, o,
    dout at H heads, k, v at Hkv; lse the forward's [B, H, S]. Returns
    (dq, dk, dv), each in its input's shape, dk and dv at Hkv heads.
    Counts one launch a call (``flash_attention_bwd.launches``)."""
    q, k, v, o, dout = (_d_contiguous(x) for x in (q, k, v, o, dout))
    b, s, h, hkv, d = (q.shape[0], q.shape[seq_axis], q.shape[head_axis],
                       k.shape[head_axis], q.shape[-1])
    dq, dk, dv = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
                  for x in (q, k, v))
    cost_analysis.report_kernel("flash_attention_bwd", lambda: cost(
        b, s, h, hkv, d, q.element_size(), causal=causal, window=window,
        prefix_len=prefix_len, backward=True))
    if q.device.type == "meta":
        return dq, dk, dv
    lib = _lib_bwd()
    # the rows' D and, under GQA, each query head's dK and dV
    work = torch.empty(lib.repro_flash_attention_bwd_workspace(b, h, hkv, s,
                                                               d),
                       dtype=torch.float32, device=q.device)

    def strides(x):
        return x.stride(0), x.stride(seq_axis), x.stride(head_axis)

    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.contiguous().data_ptr(), work.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, d,
        *(st for x in (q, k, v, o, dout, dq, dk, dv) for st in strides(x)),
        scale, int(causal), int(window), _prefix(prefix_len, s),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def launches_a_call(n_heads: int, n_kv_heads: int) -> int:
    """Device launches one :func:`flash_attention_bwd` call makes: D, dK/dV
    and dQ, and under GQA (``n_heads > n_kv_heads``) the group sum."""
    return 3 + (n_heads != n_kv_heads)


class _FlashFn(torch.autograd.Function):
    """The kernels under autograd: ``forward`` launches the forward with
    the rows' logsumexp and saves q, k, v, the output and lse; ``backward``
    launches :func:`flash_attention_bwd` and returns dq, dk and dv in the
    inputs' own layouts (dk and dv at Hkv heads), None for the rest."""

    @staticmethod
    def forward(ctx, q, k, v, seq_axis, head_axis, causal, window, scale,
                prefix_len):
        mask = dict(seq_axis=seq_axis, head_axis=head_axis, causal=causal,
                    window=window, scale=scale, prefix_len=prefix_len)
        out, lse = _forward_lse(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None, None


def _under_grad(what: str, q, k, v) -> bool:
    """Whether a CUDA call must go through :class:`_FlashFn` (grad mode on
    and an input that requires grad); raises TypeError for a bf16 input
    then, as the backward kernel takes fp32 only."""
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return False
    if q.dtype != torch.float32:
        raise TypeError(f"{what}: the backward kernel takes fp32 inputs "
                        f"only, not {q.dtype}; train in fp32")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q, k, v: [B, H, S, D] (kv already expanded to H heads) -> [B, H, S,
    D]: softmax attention with the causal mask (``causal``), under it the
    prefix-LM square (rows and keys both below ``prefix_len`` attend both
    ways), and the window mask cols > rows - window (``window > 0``);
    scale 1/sqrt(D) unless given (``ref.keep_mask``)."""
    _check(q, k, v)
    if k.shape != q.shape:
        raise ValueError(f"q/k/v shapes must match: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        b, h, s, d = q.shape
        with cost_analysis.kernel("flash_attention", lambda: cost(
                b, s, h, h, d, q.element_size(), causal=causal,
                window=window, prefix_len=prefix_len)):
            return attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, prefix_len=prefix_len)
    if _under_grad("flash_attention", q, k, v):
        return _FlashFn.apply(_d_contiguous(q), _d_contiguous(k),
                              _d_contiguous(v), 2, 1, causal, window, scale,
                              prefix_len)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, seq_axis=2, head_axis=1, causal=causal,
                   window=window, scale=scale, prefix_len=prefix_len)


flash_attention.launches = 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        prefix_len: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, Hkv, D] (GQA, H a multiple of Hkv; head
    h reads kv head h // (H / Hkv)) -> [B, S, H, D], scale 1/sqrt(D); the
    masks as in :func:`flash_attention`."""
    _check(q, k, v)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or hq % hkv:
        raise ValueError(f"mha: q={tuple(q.shape)} and k/v="
                         f"{tuple(k.shape)} need equal B, S, D and H a "
                         "multiple of Hkv")
    if q.device.type == "cpu":
        with cost_analysis.kernel("flash_attention", lambda: cost(
                b, s, hq, hkv, d, q.element_size(), causal=causal,
                window=window, prefix_len=prefix_len)):
            return mha_ref(q, k, v, causal=causal, window=window,
                           prefix_len=prefix_len)
    if _under_grad("flash_attention (mha)", q, k, v):
        return _FlashFn.apply(_d_contiguous(q), _d_contiguous(k),
                              _d_contiguous(v), 1, 2, causal, window,
                              1.0 / math.sqrt(d), prefix_len)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, seq_axis=1, head_axis=2, causal=causal,
                   window=window, scale=1.0 / math.sqrt(d),
                   prefix_len=prefix_len)
