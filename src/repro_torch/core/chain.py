"""Blockchain ledger (paper §2.2 / §3.1 Steps 2-5).

Python-level chain used by the round loop and by tests; the round state on
the device only carries ``prev_hash`` (a uint32 word) and the round
counter, and ``ledger_from_scan`` appends a full Block per integrated
round. Validation recomputes the hash links and the PoW target — a
tampered model digest or reordered chain fails verification.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import List, Optional


def sha_u32(*words: int) -> int:
    """uint32 digest via sha256 over packed words (ledger-level hash)."""
    payload = struct.pack(f"<{len(words)}I", *[w & 0xFFFFFFFF for w in words])
    return struct.unpack("<I", hashlib.sha256(payload).digest()[:4])[0]


@dataclasses.dataclass(frozen=True)
class Block:
    index: int                 # integrated round k
    prev_hash: int             # uint32
    model_digest: int          # uint32 digest of the aggregated model
    winner: int                # client id that mined the block
    nonce: int                 # winning nonce
    pow_hash: int              # mix-hash achieved by the winner (uint32)

    @property
    def header_hash(self) -> int:
        return sha_u32(self.index, self.prev_hash, self.model_digest,
                       self.winner, self.nonce, self.pow_hash)


GENESIS_HASH = sha_u32(0xB1ADE, 0xF1)


class Ledger:
    """Append-only validated chain; every client in the sim shares one copy
    (consensus is assumed honest-majority per the paper)."""

    def __init__(self, difficulty_bits: int = 0):
        self.blocks: List[Block] = []
        self.difficulty_bits = difficulty_bits

    @property
    def head_hash(self) -> int:
        return self.blocks[-1].header_hash if self.blocks else GENESIS_HASH

    def append(self, block: Block) -> None:
        if not self.validate_block(block, self.head_hash, len(self.blocks)):
            raise ValueError(f"invalid block at index {block.index}")
        self.blocks.append(block)

    def validate_block(self, block: Block, expect_prev: int, expect_idx: int) -> bool:
        if block.index != expect_idx or block.prev_hash != expect_prev:
            return False
        if self.difficulty_bits:
            target = 0xFFFFFFFF >> self.difficulty_bits
            if block.pow_hash > target:
                return False
        return True

    def validate_chain(self) -> bool:
        prev = GENESIS_HASH
        for i, b in enumerate(self.blocks):
            if not self.validate_block(b, prev, i):
                return False
            prev = b.header_hash
        return True

    def tampered_copy(self, index: int, **changes) -> "Ledger":
        """Return a copy with block ``index`` altered (for tamper tests)."""
        out = Ledger(self.difficulty_bits)
        out.blocks = list(self.blocks)
        out.blocks[index] = dataclasses.replace(out.blocks[index], **changes)
        return out


def make_block(index: int, prev_hash: int, model_digest: int, winner: int,
               nonce: int, pow_hash: int) -> Block:
    return Block(index=index, prev_hash=int(prev_hash) & 0xFFFFFFFF,
                 model_digest=int(model_digest) & 0xFFFFFFFF,
                 winner=int(winner), nonce=int(nonce) & 0xFFFFFFFF,
                 pow_hash=int(pow_hash) & 0xFFFFFFFF)


def ledger_from_scan(digests, winners, nonces, pow_hashes,
                     ledger: Optional[Ledger] = None) -> Ledger:
    """Rebuild the host-side ledger from stacked scan outputs.

    The compiled multi-round engine (core/rounds.run_blade_fl_scan) keeps all
    K rounds on device and returns the block-header fields as length-K arrays
    in a single host transfer. This replays them through ``Ledger.append``,
    which re-validates every hash link (and the PoW target when the ledger
    enforces one) — so the scan path produces the exact chain the per-round
    Python loop would have built.
    """
    ledger = ledger if ledger is not None else Ledger()
    start = len(ledger.blocks)
    for i in range(len(digests)):
        block = make_block(
            index=start + i, prev_hash=ledger.head_hash,
            model_digest=int(digests[i]), winner=int(winners[i]),
            nonce=int(nonces[i]), pow_hash=int(pow_hashes[i]))
        ledger.append(block)
    if not ledger.validate_chain():
        raise ValueError("scan-reconstructed ledger failed chain validation")
    return ledger
