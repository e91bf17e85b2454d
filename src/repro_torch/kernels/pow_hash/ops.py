"""Wrappers of the CUDA mine-stage kernel (``csrc/pow_race.cu``).

``pow_race_flat`` (the race alone) and ``mine_seal`` (the whole Step 3+4
stage: salt, race, winner, difficulty test and hash link) are the kernel's
two modes: on a CUDA tensor each launches it once (or raises), on a CPU
tensor each runs its plain version in ``ref.py``. ``pow_race`` and
``mine`` salt the payloads with ``mining.client_salt`` first, like the
JAX package's ``ops.pow_race`` and ``ops.mine``. Words are uint32 values
held in int64 tensors.

On meta tensors (the dry-run) both modes return their outputs as meta
tensors of their shapes, compute nothing and never run the plain version.
Every call reports the kernel's cost to the active ``launch.cost_analysis``
counters: OPS_PER_HASH integer ops a hash of the C x n_attempts budget
(counted as flops), the payloads and words read and the outputs written
once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mining
from repro_torch.kernels import _build
from repro_torch.kernels.pow_hash.ref import mine_seal_ref, pow_race_ref
from repro_torch.launch import cost_analysis

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "repro_pow_race": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_mine_seal": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_uint, _P, _P,
                        _P, _P, _P],
}
_MAX_CLIENTS = 65535          # gridDim.y
_MAX_ATTEMPTS = (1 << 31) - 1
_MAX_CHUNK = 1 << 24
# the tile the wrapper picks (race_tile): one block a client up to
# BLOCK_ATTEMPTS attempts, so flat mode at the paper's budget takes no
# ticket; else enough blocks of about BLOCK_ATTEMPTS to fill the card, at
# most MAX_BLOCKS in all unless C alone needs more
BLOCK_ATTEMPTS = 16384
MAX_BLOCKS = 2048
# 32-bit integer ops of one hash (the kernel table's rate, PERF.md §6)
OPS_PER_HASH = 12

def _lib() -> ctypes.CDLL:
    lib = _build.load("pow_race")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _word(t: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.numel() != 1:
        raise TypeError(f"{name} must be a one-element int64 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    return t.reshape(())


def _check_race(device: torch.device, c: int, n_attempts: int,
                chunk: Optional[int]) -> None:
    if not 1 <= c <= _MAX_CLIENTS:
        raise ValueError(f"need 1 <= C <= {_MAX_CLIENTS}, got {c}")
    if not 1 <= n_attempts <= _MAX_ATTEMPTS:
        raise ValueError(f"n_attempts must lie in [1, 2**31), got {n_attempts}")
    if chunk is not None and not 1 <= chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must lie in [1, 2**24], got {chunk}")
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the mine kernel runs on cuda, cpu or meta, not "
                         f"{device}")


def race_tile(n_attempts: int, n_clients: int,
              chunk: Optional[int] = None) -> int:
    """The nonce tile of one CUDA block: ``chunk`` when given (raised so
    that the partial keys stay below MAX_BLOCKS * 2**10), else one block a
    client up to BLOCK_ATTEMPTS attempts, else enough tiles to fill the
    card. The result does not depend on it."""
    if chunk is not None:
        floor = -(-n_attempts * n_clients // (MAX_BLOCKS << 10))
        return min(max(chunk, floor), n_attempts)
    tiles = min(-(-n_attempts // BLOCK_ATTEMPTS),
                max(1, MAX_BLOCKS // n_clients))
    return -(-n_attempts // tiles)


def _launch_buffers(dev: torch.device, c: int, n_attempts: int, tile: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(partial keys [C * tiles], the stream's ticket, the stream
    handle)."""
    ticket, stream = _build.stream_ticket(dev, "pow_race")
    part = torch.empty(c * -(-n_attempts // tile), dtype=torch.int64,
                       device=dev)
    return part, ticket, stream


def pow_race_flat(prev_hash: torch.Tensor, payloads: torch.Tensor,
                  nonce_offset: torch.Tensor, n_attempts: int, *,
                  chunk: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole race for ``[C]`` pre-salted payloads: per client, the min
    hash over nonces ``off + j, j < n_attempts`` and the nonce of the first
    ``j`` reaching it. ``prev_hash`` and ``nonce_offset`` are one-element
    int64 tensors on the payloads' device. ``chunk`` forces the nonce tile
    of one CUDA block (see :func:`race_tile`); the result does not depend
    on it. Returns int64 ``(best_hashes [C], best_nonces [C])``, bitwise
    equal to the JAX package's ``pow_race_kernel``."""
    if not isinstance(payloads, torch.Tensor) or payloads.dtype != torch.int64 \
            or payloads.dim() != 1 or not payloads.is_contiguous():
        raise TypeError("payloads must be a contiguous int64 [C] tensor")
    dev = payloads.device
    prev_hash = _word(prev_hash, "prev_hash", dev)
    nonce_offset = _word(nonce_offset, "nonce_offset", dev)
    c, n_attempts = payloads.shape[0], int(n_attempts)
    chunk = None if chunk is None else int(chunk)
    _check_race(dev, c, n_attempts, chunk)

    def cost():   # the payloads and two words read; C hashes, C nonces out
        return OPS_PER_HASH * c * n_attempts, 8.0 * (3 * c + 2)

    if dev.type == "cpu":
        with cost_analysis.kernel("pow_race", cost):
            return pow_race_ref(prev_hash, nonce_offset, payloads,
                                n_attempts)
    best_h = torch.empty(c, dtype=torch.int64, device=dev)
    best_n = torch.empty(c, dtype=torch.int64, device=dev)
    cost_analysis.report_kernel("pow_race", cost)
    if dev.type == "meta":
        return best_h, best_n
    lib = _lib()
    tile = race_tile(n_attempts, c, chunk)
    part, ticket, stream = _launch_buffers(dev, c, n_attempts, tile)
    err = lib.repro_pow_race(prev_hash.data_ptr(), nonce_offset.data_ptr(),
                             payloads.data_ptr(), c, n_attempts, tile,
                             part.data_ptr(), ticket.data_ptr(),
                             best_h.data_ptr(), best_n.data_ptr(), stream)
    _build.check(lib, err, "pow_race")
    pow_race_flat.launches += 1
    return best_h, best_n


pow_race_flat.launches = 0


def mine_seal(prev_hash: torch.Tensor, digest: torch.Tensor, n_clients: int,
              n_attempts: int, *, nonce_offset: torch.Tensor,
              difficulty_bits: int, chunk: Optional[int] = None,
              payloads: Optional[torch.Tensor] = None
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Steps 3+4 in one launch: clients ``0..n_clients-1`` race on the
    digest salted with ``mining.client_salt`` (or on ``payloads [C]``,
    pre-salted, when given); the winner is the first client with the least
    hash, ``solved`` is ``pow_hash <= 0xFFFFFFFF >> difficulty_bits``, and
    its nonce links ``new_hash = mix_hash(prev_hash, digest, nonce)`` with
    the unsalted digest. ``prev_hash``, ``digest`` and ``nonce_offset`` are
    one-element int64 tensors on one device. Returns ``({"winner",
    "pow_hash", "nonce", "solved"}, new_hash)``: 0-d int64 words and a 0-d
    bool, bitwise equal to the JAX package's ``make_mine`` stage. The
    launch counts in ``pow_race_flat.launches``."""
    if not isinstance(digest, torch.Tensor):
        raise TypeError("digest must be a one-element int64 tensor")
    dev = digest.device
    digest = _word(digest, "digest", dev)
    prev_hash = _word(prev_hash, "prev_hash", dev)
    nonce_offset = _word(nonce_offset, "nonce_offset", dev)
    c, n_attempts = int(n_clients), int(n_attempts)
    chunk = None if chunk is None else int(chunk)
    _check_race(dev, c, n_attempts, chunk)
    bits = int(difficulty_bits)
    if not 0 <= bits <= 32:
        raise ValueError(f"difficulty_bits must lie in [0, 32], got {bits}")
    if payloads is not None and (
            not isinstance(payloads, torch.Tensor)
            or payloads.dtype != torch.int64 or payloads.shape != (c,)
            or not payloads.is_contiguous() or payloads.device != dev):
        raise TypeError(f"payloads must be a contiguous int64 [{c}] tensor "
                        f"on {dev}")

    def cost():   # three words (and the payloads) read; four words and a
        # flag written
        return (OPS_PER_HASH * c * n_attempts,
                8.0 * (3 + (c if payloads is not None else 0) + 4) + 1)

    if dev.type == "cpu":
        with cost_analysis.kernel("mine_seal", cost):
            return mine_seal_ref(prev_hash, digest, nonce_offset, c,
                                 n_attempts, bits, payloads)
    out = torch.empty(4, dtype=torch.int64, device=dev)
    solved = torch.empty((), dtype=torch.bool, device=dev)
    cost_analysis.report_kernel("mine_seal", cost)
    if dev.type == "meta":
        return ({"winner": out[0], "pow_hash": out[1], "nonce": out[2],
                 "solved": solved}, out[3])
    lib = _lib()
    tile = race_tile(n_attempts, c, chunk)
    part, ticket, stream = _launch_buffers(dev, c, n_attempts, tile)
    err = lib.repro_mine_seal(
        prev_hash.data_ptr(), nonce_offset.data_ptr(),
        None if payloads is None else payloads.data_ptr(), digest.data_ptr(),
        c, n_attempts, tile, mining.difficulty_threshold(bits),
        part.data_ptr(), ticket.data_ptr(), out.data_ptr(), solved.data_ptr(),
        stream)
    _build.check(lib, err, "mine_seal")
    pow_race_flat.launches += 1
    metrics = {"winner": out[0], "pow_hash": out[1], "nonce": out[2],
               "solved": solved}
    return metrics, out[3]


def pow_race(prev_hash: torch.Tensor, payload: torch.Tensor,
             client_ids: torch.Tensor, n_attempts: int, *,
             nonce_offset: torch.Tensor, chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Step-3 race of clients ``client_ids [C]`` on one payload (the
    model digest), each salted with ``mining.client_salt``."""
    payloads = (payload ^ mining.client_salt(client_ids)).contiguous()
    return pow_race_flat(prev_hash, payloads, nonce_offset, n_attempts,
                         chunk=chunk)


def mine(prev_hash: torch.Tensor, payload: torch.Tensor,
         client_id: torch.Tensor, n_attempts: int, *,
         nonce_offset: torch.Tensor, chunk: Optional[int] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-client race (the JAX package's ``pow_search_kernel`` path):
    the C = 1 case of :func:`pow_race`. Returns 0-d (hash, nonce)."""
    h, n = pow_race(prev_hash, payload, client_id.reshape(1), n_attempts,
                    nonce_offset=nonce_offset, chunk=chunk)
    return h[0], n[0]
