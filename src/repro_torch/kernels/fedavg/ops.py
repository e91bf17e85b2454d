"""Wrappers of the CUDA aggregation kernels (``csrc/fedavg.cu``) and their
dict-of-leaves forms.

``fedavg_flat`` and ``digest_div_flat`` are the kernels' wrappers: on a
CUDA tensor they launch the kernel (or raise), on a CPU tensor they run the
plain version in ``ref.py``. ``fedavg_tree`` and
``digest_divergence_tree`` flatten every ``[C, ...]`` leaf to ``[C, N]``
and call them once per leaf, in sorted key order (the JAX package's
``jax.tree.leaves`` order for dict params).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mining
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import (digest_div_flat_ref,
                                            fedavg_flat_ref)

_P = ctypes.c_void_p
_SIGNATURES = {
    "repro_fedavg_flat": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "repro_digest_div": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         _P, _P, _P, _P, _P],
}
# columns per block of the digest/divergence sweep (its shared-memory tile)
DIGEST_TILE = 1024

Tree = Dict[str, torch.Tensor]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fedavg")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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


def digest_div_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep of x [C, N] f32 for both diagnostics of the communicate
    stage: (leaf sum, 0-d f32; per-client sum_n (x[c, n] - colmean[n])^2,
    [C] f32). The CUDA path sums in a fixed order, so it gives the same
    bits on every run."""
    _check_flat(x, "digest_div_flat")
    if x.device.type == "cpu":
        return digest_div_flat_ref(x)
    lib = _lib()
    c, n = x.shape
    n_blocks = -(-n // DIGEST_TILE)
    part_sum = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    part_res = torch.empty((n_blocks, c), dtype=torch.float32, device=x.device)
    out_sum = torch.empty((), dtype=torch.float32, device=x.device)
    out_res = torch.empty(c, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_digest_div(x.data_ptr(), c, n, DIGEST_TILE,
                               part_sum.data_ptr(), part_res.data_ptr(),
                               out_sum.data_ptr(), out_res.data_ptr(), stream)
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
