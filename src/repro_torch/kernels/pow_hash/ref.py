"""Plain PyTorch versions of the mine-stage kernel's two modes: the CPU
paths of ``ops.pow_race_flat`` and ``ops.mine_seal`` and the oracles the
CUDA kernel is held to, bitwise."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mining


def _unshift(h: int, s: int) -> int:
    """The x with ``x ^ (x >> s) == h`` (32-bit words)."""
    x = h
    for _ in range(32 // s + 1):
        x = h ^ (x >> s)
    return x & mining.MASK


def _unavalanche(h: int) -> int:
    """The inverse of ``mining._avalanche`` on one word: each xorshift and
    each odd multiplication is a bijection of the 32-bit words."""
    h = _unshift(h, 16)
    h = (h * pow(mining._M3, -1, 1 << 32)) & mining.MASK
    h = _unshift(h, 13)
    h = (h * pow(mining._M2, -1, 1 << 32)) & mining.MASK
    return _unshift(h, 15)


def payload_hashing_to(prev_hash: int, nonce: int, target: int) -> int:
    """The payload word whose race hash ``mix_hash(prev_hash, payload,
    nonce)`` is ``target``: with ``target`` 0xFFFFFFFF and a budget of one
    attempt from ``nonce``, a client whose every hash is the max."""
    inner = _unavalanche(target) ^ (nonce & mining.MASK)
    return _unavalanche(inner) ^ ((prev_hash * mining._M1) & mining.MASK)


def pow_race_ref(prev_hash: torch.Tensor, nonce_offset: torch.Tensor,
                 payloads: torch.Tensor, n_attempts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute force over the whole budget: for each pre-salted payload
    ``[C]``, the min hash over ``off + j, j < n_attempts`` and the nonce of
    the first ``j`` reaching it (nonce 0 when the min is 0xFFFFFFFF, as in
    the chunked reference). Returns int64 ``([C], [C])``."""
    lane = torch.arange(int(n_attempts), dtype=torch.int64,
                        device=payloads.device)
    nonces = (nonce_offset + lane) & mining.MASK
    hs = mining.mix_hash(prev_hash, payloads[:, None], nonces[None, :])
    j = mining.first_argmin(hs)
    best_h = hs.gather(1, j[:, None])[:, 0]
    best_n = torch.where(best_h == mining.MASK, 0, nonces[j])
    return best_h, best_n


def mine_seal_ref(prev_hash: torch.Tensor, digest: torch.Tensor,
                  nonce_offset: torch.Tensor, n_clients: int,
                  n_attempts: int, difficulty_bits: int,
                  payloads: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Steps 3+4 composed from the plain pieces: clients ``0..C-1`` race
    on ``digest ^ client_salt(c)`` (or on ``payloads``, pre-salted), the
    winner is the first argmin of their best hashes, and its nonce links
    the new block onto ``prev_hash`` with the unsalted digest. Returns
    ``({"winner", "pow_hash", "nonce", "solved"}, new_hash)``."""
    if payloads is None:
        ids = torch.arange(int(n_clients), dtype=torch.int64,
                           device=digest.device)
        payloads = digest ^ mining.client_salt(ids)
    best_h, best_n = pow_race_ref(prev_hash, nonce_offset, payloads,
                                  n_attempts)
    winner = mining.winner_of(best_h)
    # index_select, not best_h[winner]: no device-to-host read
    at = winner.reshape(1)
    pow_hash = best_h.index_select(0, at).reshape(())
    nonce = best_n.index_select(0, at).reshape(())
    solved = pow_hash <= mining.difficulty_threshold(difficulty_bits)
    new_hash = mining.mix_hash(prev_hash, digest, nonce)
    return ({"winner": winner, "pow_hash": pow_hash, "nonce": nonce,
             "solved": solved}, new_hash)
