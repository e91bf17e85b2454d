"""Plain PyTorch version of the PoW race: the CPU path of
``ops.pow_race`` and the oracle the CUDA kernel is held to, bitwise."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import mining


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
