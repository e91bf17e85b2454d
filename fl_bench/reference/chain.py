"""The proof-of-work race and the ledger's hash links, in numpy, from the
BLADE-FL round's published arithmetic (uint32 words).

Round k of a job races every client c over ``attempts`` nonces from
``(k << 20) mod 2**32``: client c hashes the round's digest salted with
``salt(c)``, keeps its least hash (the first nonce on ties), the winner is
the first client with the least hash, and the winner's nonce links the next
round's ``prev = mix_hash(prev, digest, nonce)``, from ``GENESIS``. The
ledger's blocks link by a sha256 header hash. The round's digest folds
each leaf's fp32 sum over the clients' rows, in the leaves' sorted order,
from ``DIGEST_INIT``: ``acc = avalanche(acc ^ bits(sum))``.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Sequence

import numpy as np

MASK = 0xFFFFFFFF
_M1, _M2, _M3 = 2654435761, 2246822519, 3266489917


def sha_u32(*words: int) -> int:
    payload = struct.pack(f"<{len(words)}I", *[w & MASK for w in words])
    return struct.unpack("<I", hashlib.sha256(payload).digest()[:4])[0]


GENESIS = sha_u32(0xB1ADE, 0xF1)
DIGEST_INIT = 0x9E3779B9


def _mul(h: np.ndarray, m: int) -> np.ndarray:
    return (h * np.uint64(m)) & np.uint64(MASK)


def _avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(15))
    h = _mul(h, _M2)
    h = h ^ (h >> np.uint64(13))
    h = _mul(h, _M3)
    return h ^ (h >> np.uint64(16))


def mix_hash(prev, payload, nonce) -> np.ndarray:
    h = _mul(np.asarray(prev, np.uint64), _M1)
    h = _avalanche(h ^ np.asarray(payload, np.uint64))
    return _avalanche(h ^ np.asarray(nonce, np.uint64))


def salt(client: np.ndarray) -> np.ndarray:
    return _avalanche(_mul(np.asarray(client, np.uint64), _M2))


def fold_digest(sums: Sequence[float]) -> int:
    """The digest of a round whose leaves (in sorted order) sum to
    ``sums`` (each taken as fp32)."""
    acc = np.uint64(DIGEST_INIT)
    for s in sums:
        bits = np.array([s], dtype=np.float32).view(np.uint32)[0]
        acc = _avalanche(acc ^ np.uint64(bits))
    return int(acc)


def race(prev: int, digest: int, n_clients: int, attempts: int,
         round_idx: int):
    """(winner, nonce, pow_hash) of one round's race."""
    offset = (round_idx << 20) & MASK
    nonces = (np.uint64(offset) + np.arange(attempts, dtype=np.uint64)) \
        & np.uint64(MASK)
    payloads = np.uint64(digest) ^ salt(np.arange(n_clients))
    hashes = mix_hash(prev, payloads[:, None], nonces[None, :])
    best = hashes.argmin(axis=1)                 # first nonce on ties
    best_h = hashes[np.arange(n_clients), best]
    winner = int(best_h.argmin())                # first client on ties
    return winner, int(nonces[best[winner]]), int(best_h[winner])


def check_job(rounds: Sequence[Dict[str, float]], blocks: List,
              n_clients: int, attempts: int) -> int:
    """How many of a job's rounds disagree with the race recomputed from
    the round's digest and the chain so far (winner, nonce, pow_hash), or
    whose ledger block differs from the one those fields make (index,
    prev_hash, the fields, the sha header link)."""
    bad = 0
    prev, head = GENESIS, GENESIS
    if len(blocks) != len(rounds):
        return len(rounds) + abs(len(blocks) - len(rounds))
    for k, (r, b) in enumerate(zip(rounds, blocks)):
        digest = int(r["digest"])
        want = race(prev, digest, n_clients, attempts, k)
        got = (int(r["winner"]), int(r["nonce"]), int(r["pow_hash"]))
        fields = (b.index, b.prev_hash, b.model_digest, b.winner, b.nonce,
                  b.pow_hash)
        if got != want or fields != (k, head, digest, *got) \
                or b.header_hash != sha_u32(*fields):
            bad += 1
        head = sha_u32(*fields)
        prev = int(mix_hash(prev, digest, got[1]))
    return bad
