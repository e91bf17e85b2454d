"""Wrappers of the CUDA PoW race (``csrc/pow_race.cu``).

``pow_race_flat`` is the kernel's wrapper: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain version in
``ref.py``. ``pow_race`` and ``mine`` salt the payloads with
``mining.client_salt`` first, like the JAX package's ``ops.pow_race`` and
``ops.mine``. Words are uint32 values held in int64 tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import mining
from repro_torch.kernels import _build
from repro_torch.kernels.pow_hash.ref import pow_race_ref

_P = ctypes.c_void_p
_SIGNATURE = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
              _P, _P]
_MAX_CLIENTS = 65535          # gridDim.y
_MAX_ATTEMPTS = (1 << 31) - 1
_MAX_CHUNK = 1 << 24


def _lib() -> ctypes.CDLL:
    lib = _build.load("pow_race")
    if lib.repro_pow_race.argtypes is None:
        lib.repro_pow_race.argtypes = _SIGNATURE
        lib.repro_pow_race.restype = ctypes.c_int
    return lib


def _word(t: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element int64 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, payloads on {device}")
    return t.reshape(())


def pow_race_flat(prev_hash: torch.Tensor, payloads: torch.Tensor,
                  nonce_offset: torch.Tensor, n_attempts: int, *,
                  chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole race for ``[C]`` pre-salted payloads: per client, the min
    hash over nonces ``off + j, j < n_attempts`` and the nonce of the first
    ``j`` reaching it. ``prev_hash`` and ``nonce_offset`` are one-element
    int64 tensors on the payloads' device. ``chunk`` is the nonce tile of
    one CUDA block; the result does not depend on it. Returns int64
    ``(best_hashes [C], best_nonces [C])``, bitwise equal to the JAX
    package's ``pow_race_kernel``."""
    if not isinstance(payloads, torch.Tensor) or payloads.dtype != torch.int64 \
            or payloads.dim() != 1 or not payloads.is_contiguous():
        raise TypeError("payloads must be a contiguous int64 [C] tensor")
    dev = payloads.device
    prev_hash = _word(prev_hash, "prev_hash", dev)
    nonce_offset = _word(nonce_offset, "nonce_offset", dev)
    n_attempts, chunk = int(n_attempts), int(chunk)
    c = payloads.shape[0]
    if not 1 <= c <= _MAX_CLIENTS:
        raise ValueError(f"need 1 <= C <= {_MAX_CLIENTS}, got {c}")
    if not 1 <= n_attempts <= _MAX_ATTEMPTS:
        raise ValueError(f"n_attempts must lie in [1, 2**31), got {n_attempts}")
    if not 1 <= chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must lie in [1, 2**24], got {chunk}")
    if dev.type == "cpu":
        return pow_race_ref(prev_hash, nonce_offset, payloads, n_attempts)
    if dev.type != "cuda":
        raise ValueError(f"pow_race_flat runs on cuda or cpu, not {dev}")
    lib = _lib()
    chunk = min(chunk, n_attempts)
    scratch = torch.empty(c, dtype=torch.int64, device=dev)
    best_h = torch.empty(c, dtype=torch.int64, device=dev)
    best_n = torch.empty(c, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_pow_race(prev_hash.data_ptr(), nonce_offset.data_ptr(),
                             payloads.data_ptr(), c, n_attempts, chunk,
                             scratch.data_ptr(), best_h.data_ptr(),
                             best_n.data_ptr(), stream)
    _build.check(lib, err, "pow_race")
    pow_race_flat.launches += 1
    return best_h, best_n


pow_race_flat.launches = 0


def pow_race(prev_hash: torch.Tensor, payload: torch.Tensor,
             client_ids: torch.Tensor, n_attempts: int, *,
             nonce_offset: torch.Tensor, chunk: int = 1024
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Step-3 race of clients ``client_ids [C]`` on one payload (the
    model digest), each salted with ``mining.client_salt``."""
    payloads = (payload ^ mining.client_salt(client_ids)).contiguous()
    return pow_race_flat(prev_hash, payloads, nonce_offset, n_attempts,
                         chunk=chunk)


def mine(prev_hash: torch.Tensor, payload: torch.Tensor,
         client_id: torch.Tensor, n_attempts: int, *,
         nonce_offset: torch.Tensor, chunk: int = 1024
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-client race (the JAX package's ``pow_search_kernel`` path):
    the C = 1 case of :func:`pow_race`. Returns 0-d (hash, nonce)."""
    h, n = pow_race(prev_hash, payload, client_id.reshape(1), n_attempts,
                    nonce_offset=nonce_offset, chunk=chunk)
    return h[0], n[0]
