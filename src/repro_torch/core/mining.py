"""Proof-of-Work simulation (paper §2.2, §3.1 Step 3), in PyTorch.

The PoW is an integer mixing hash (xorshift-mult avalanche) searched over a
calibrated number of nonce attempts; the eq.-1 budget accounting is what
matters, not cryptographic strength. Every function here is bitwise equal
to its counterpart in the JAX package.

uint32 words are held in ``int64`` tensors with values in ``[0, 2**32)``:
torch's ``uint32`` lacks ``>>``, ``<`` and ``argmin`` on the CPU. Products
are formed by :func:`_mul32` from two 16-bit halves, so no intermediate
leaves the int64 range and the low 32 bits come out exact.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_M1 = 2654435761   # Knuth multiplicative
_M2 = 2246822519
_M3 = 3266489917

# Initial accumulator of the per-leaf digest fold (golden-ratio constant).
DIGEST_INIT = 0x9E3779B9


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``(h * m) mod 2**32`` for int64 ``h`` in ``[0, 2**32)`` and a uint32
    constant ``m``; both partial products stay below ``2**48``."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    h = h ^ (h >> 13)
    h = _mul32(h, _M3)
    h = h ^ (h >> 16)
    return h


def as_word(x, device=None) -> torch.Tensor:
    """A uint32 word (Python int, numpy value or tensor) as an int64 tensor
    with the value reduced mod 2**32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    # a fill on the device, not a copy from the host (which would sync)
    return torch.full((), int(x) & MASK, dtype=torch.int64, device=device)


def mix_hash(prev_hash: torch.Tensor, payload: torch.Tensor,
             nonce: torch.Tensor) -> torch.Tensor:
    """uint32 hash of (prev_hash, payload, nonce); broadcasts over nonce."""
    h = _mul32(prev_hash, _M1)
    h = _avalanche(h ^ payload)
    return _avalanche(h ^ nonce)


def client_salt(client_id: torch.Tensor) -> torch.Tensor:
    """Per-client payload salt defining the disjoint nonce spaces of the
    race. One definition shared by :func:`pow_search` and the CUDA race
    (``kernels/pow_hash``); broadcasts over a vector of client ids."""
    return _avalanche(_mul32(as_word(client_id), _M2))


def fold_digest(acc: torch.Tensor, leaf_sum: torch.Tensor) -> torch.Tensor:
    """Fold one leaf's fp32 sum into the running digest: the fp32 bits of
    the sum, read as uint32, are xored in and avalanched."""
    bits = leaf_sum.to(torch.float32).reshape(()).view(torch.int32)
    return _avalanche(acc ^ (bits.to(torch.int64) & MASK))


def digest_tree(tree, mesh=None, model=None) -> torch.Tensor:
    """uint32 digest of a dict of tensors (the model fingerprint in the
    block header). Leaves fold in sorted key order, which is the JAX
    package's ``jax.tree.leaves`` order for dict params.

    With ``mesh`` (a ``launch.mesh.ClientMesh``; the psum tier) the tree
    holds this rank's client rows and each leaf's sum is all-reduced over
    the ranks: no gather, but the reassociated fp32 sum forks the digest,
    and every later ledger hash, from the one-process value. With
    ``model`` (``aggregation.ModelBlocks``) a split leaf's sum is then
    summed over its model blocks."""
    keys = sorted(tree)
    acc = as_word(DIGEST_INIT, tree[keys[0]].device)
    for k in keys:
        x = tree[k]
        if x.is_floating_point():
            s = x.to(torch.float32).sum()
        else:
            s = x.to(torch.int32).sum(dtype=torch.int32).to(torch.float32)
        if mesh is not None:
            s = mesh.all_reduce(s)
        if model is not None:
            s = model.sum(k, s)
        acc = fold_digest(acc, s)
    return acc


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum of the last axis, on any device."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    hit = x == x.min(dim=-1, keepdim=True).values
    return torch.where(hit, idx, n).min(dim=-1).values


def pow_search(prev_hash, payload, client_id, n_attempts: int,
               nonce_offset=0, chunk: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search ``n_attempts`` nonces; return (best_hash, best_nonce).

    The client salts its payload with its id (disjoint search). The search
    runs in chunks with a first-index argmin inside a chunk and a strict
    ``<`` across chunks, starting from ``(0xFFFFFFFF, 0)``, exactly as the
    JAX package's ``fori_loop``; the tail chunk charges only the nonces
    below ``n_attempts`` (eq. 1)."""
    n_attempts = int(n_attempts)
    chunk = min(int(chunk), n_attempts)
    n_chunks = -(-n_attempts // chunk)
    prev = as_word(prev_hash)
    dev = prev.device
    payload_s = as_word(payload, dev) ^ client_salt(as_word(client_id, dev))
    base = as_word(nonce_offset, dev)
    best_h = as_word(MASK, dev)
    best_n = as_word(0, dev)
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    for i in range(n_chunks):
        attempt = i * chunk + lane
        nonces = (base + attempt) & MASK
        hs = mix_hash(prev, payload_s, nonces)
        hs = torch.where(attempt < n_attempts, hs, MASK)
        j = first_argmin(hs)
        take = hs[j] < best_h
        best_h = torch.where(take, hs[j], best_h)
        best_n = torch.where(take, nonces[j], best_n)
    return best_h, best_n


def difficulty_threshold(difficulty_bits: int) -> int:
    """Hash must be at most this to 'solve' the block."""
    return MASK >> int(difficulty_bits)


def winner_of(best_hashes: torch.Tensor) -> torch.Tensor:
    """argmin over the client axis (first index on ties) = first solver."""
    return first_argmin(best_hashes)
