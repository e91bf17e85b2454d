"""Wrappers of the CUDA aggregation kernels (``csrc/fedavg.cu``) and their
dict-of-leaves forms.

``fedavg_flat``, ``mix_rows_flat`` and ``digest_div_flat`` are the kernels'
wrappers: on a CUDA tensor they launch the kernel (or raise), on a CPU
tensor they run the plain version in ``ref.py``. ``fedavg_tree``,
``mix_rows_tree`` and ``digest_divergence_tree`` flatten every ``[C, ...]``
leaf to ``[C, N]`` and call them once per leaf, in sorted key order (the
JAX package's ``jax.tree.leaves`` order for dict params).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mining
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import (digest_div_flat_ref,
                                            fedavg_flat_ref,
                                            mix_rows_flat_ref)

_P = ctypes.c_void_p
_SIGNATURES = {
    "repro_fedavg_flat": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "repro_digest_div": [_P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P,
                         _P, _P],
    "repro_mix_rows": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, _P],
}
# largest R of mix_rows_flat: the grid's 65 535 row blocks (blockIdx.y) of
# 4 rows, the narrowest block the kernel runs; K has no limit
MIX_MAX_ROWS = 4 * 65535

Tree = Dict[str, torch.Tensor]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fedavg")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    blocks = lib.repro_digest_div_blocks
    if blocks.argtypes is None:
        blocks.argtypes = [_P, ctypes.c_int, ctypes.c_longlong]
        blocks.restype = ctypes.c_longlong
    return lib


def _check_flat(x: torch.Tensor, what: str) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"{what}: x must be a contiguous float32 [C, N] tensor")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: empty x of shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def fedavg_flat(x: torch.Tensor, weights: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [C, N] f32; weights: [C] f32, normalised; noise: [C, N] f32 or
    None. Returns [C, N]: the weighted client mean in every row, plus that
    row's noise."""
    _check_flat(x, "fedavg_flat")
    c, n = x.shape
    if not isinstance(weights, torch.Tensor) or weights.dtype != torch.float32 \
            or weights.shape != (c,) or not weights.is_contiguous() \
            or weights.device != x.device:
        raise TypeError("fedavg_flat: weights must be a contiguous float32 "
                        f"[{c}] tensor on {x.device}")
    if noise is not None and (noise.dtype != torch.float32
                              or noise.shape != x.shape
                              or not noise.is_contiguous()
                              or noise.device != x.device):
        raise TypeError("fedavg_flat: noise must be a contiguous float32 "
                        f"{list(x.shape)} tensor on {x.device}")
    if x.device.type == "cpu":
        return fedavg_flat_ref(x, weights, noise)
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_fedavg_flat(x.data_ptr(), weights.data_ptr(),
                                None if noise is None else noise.data_ptr(),
                                out.data_ptr(), c, n, stream)
    _build.check(lib, err, "fedavg_flat")
    fedavg_flat.launches += 1
    return out


fedavg_flat.launches = 0


def mix_rows_flat(w_rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w_rows: [R, K] f32; x: [K, N] f32 -> [R, N] = w_rows @ x, with R <=
    MIX_MAX_ROWS and any K. The CUDA path adds the rounded products in
    ascending k, as ``mix_rows_flat_ref`` does, so the two agree bitwise."""
    _check_flat(x, "mix_rows_flat")
    k, n = x.shape
    if not isinstance(w_rows, torch.Tensor) or w_rows.dtype != torch.float32 \
            or w_rows.dim() != 2 or w_rows.shape[1] != k \
            or not w_rows.is_contiguous() or w_rows.device != x.device:
        raise TypeError("mix_rows_flat: w_rows must be a contiguous float32 "
                        f"[R, {k}] tensor on {x.device}")
    r = w_rows.shape[0]
    if not 1 <= r <= MIX_MAX_ROWS:
        raise ValueError(f"mix_rows_flat: R={r}; the kernel's grid takes "
                         f"1 <= R <= {MIX_MAX_ROWS} (65 535 row blocks of "
                         "4 rows)")
    if x.device.type == "cpu":
        return mix_rows_flat_ref(w_rows, x)
    lib = _lib()
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_mix_rows(w_rows.data_ptr(), x.data_ptr(), out.data_ptr(),
                             r, k, n, stream)
    _build.check(lib, err, "mix_rows_flat")
    mix_rows_flat.launches += 1
    return out


mix_rows_flat.launches = 0


def digest_div_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep of x [C, N] f32 for both diagnostics of the communicate
    stage: (leaf sum, 0-d f32; per-client sum_n (x[c, n] - colmean[n])^2,
    [C] f32). The CUDA path is one launch that sums in a fixed order, so
    it gives the same bits on every run at the same shape on the same
    card."""
    _check_flat(x, "digest_div_flat")
    if x.device.type == "cpu":
        return digest_div_flat_ref(x)
    c, n = x.shape
    lib = _lib()
    blocks = lib.repro_digest_div_blocks(x.data_ptr(), c, n)
    if blocks < 1:
        _build.check(lib, int(-blocks), "digest_div_flat")
    ticket, stream = _build.stream_ticket(x.device, "digest_div_flat")
    part = torch.empty((blocks, c + 1), dtype=torch.float32, device=x.device)
    out_sum = torch.empty((), dtype=torch.float32, device=x.device)
    out_res = torch.empty(c, dtype=torch.float32, device=x.device)
    err = lib.repro_digest_div(x.data_ptr(), c, n, part.data_ptr(),
                               ticket.data_ptr(), out_sum.data_ptr(),
                               out_res.data_ptr(), stream)
    _build.check(lib, err, "digest_div_flat")
    digest_div_flat.launches += 1
    return out_sum, out_res


digest_div_flat.launches = 0


def _flat(leaf: torch.Tensor, c: int) -> torch.Tensor:
    return leaf.to(torch.float32).reshape(c, -1).contiguous()


def fedavg_tree(params: Tree, weights: Optional[torch.Tensor] = None,
                noise_tree: Optional[Tree] = None) -> Tree:
    """params: dict of ``[C, ...]`` leaves. Every client slot of the result
    holds the weighted mean (uniform when ``weights`` is None) plus the
    leaf's noise, if given."""
    keys = sorted(params)
    first = params[keys[0]]
    c = first.shape[0]
    if weights is None:
        w = torch.full((c,), 1.0 / c, dtype=torch.float32, device=first.device)
    else:
        w = (weights / weights.sum()).to(torch.float32).contiguous()
    out = {}
    for k in keys:
        leaf = params[k]
        nz = None if noise_tree is None else _flat(noise_tree[k], c)
        agg = fedavg_flat(_flat(leaf, c), w, nz)
        out[k] = agg.reshape(leaf.shape).to(leaf.dtype)
    return out


def mix_rows_tree(params: Tree, w_rows: torch.Tensor) -> Tree:
    """params: dict of ``[C, ...]`` leaves; w_rows: ``[R, C]`` (already
    reweighted). Each leaf comes back as ``[R, ...]``: row i is
    ``sum_c w_rows[i, c] * leaf[c]``."""
    out = {}
    for k in sorted(params):
        leaf = params[k]
        mixed = mix_rows_flat(w_rows, _flat(leaf, leaf.shape[0]))
        out[k] = mixed.reshape((w_rows.shape[0],) + leaf.shape[1:]) \
            .to(leaf.dtype)
    return out


def digest_divergence_tree(tree: Tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model digest and client divergence from one sweep of each leaf.
    Returns (digest, 0-d int64 word; divergence, 0-d f32) where divergence
    is ``sqrt(mean_c sum_leaves residual[c])``, the JAX package's
    ``client_divergence``. Tolerance tier: the leaf sums are associated
    differently from ``mining.digest_tree``, so the digest (and the ledger)
    forks from it deterministically. Leaves must be floating point."""
    keys = sorted(tree)
    c = tree[keys[0]].shape[0]
    acc = mining.as_word(mining.DIGEST_INIT, tree[keys[0]].device)
    total = None
    for k in keys:
        if not tree[k].is_floating_point():
            raise TypeError(f"digest_divergence_tree: leaf {k!r} is "
                            f"{tree[k].dtype}, not floating point")
        s, res = digest_div_flat(_flat(tree[k], c))
        acc = mining.fold_digest(acc, s)
        total = res if total is None else total + res
    return acc, torch.sqrt(total.mean())
