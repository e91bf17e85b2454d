"""Plain PyTorch versions of the flash-attention kernel: the CPU paths of
``ops.flash_attention`` (``attention_ref``, the JAX package's
``kernels/flash_attention/ref.py``) and ``ops.mha`` (``mha_ref``), and the
oracles the CUDA kernel is held to."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D]; full softmax attention with
    the dense [S, S] mask, in fp32, output in q's dtype."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (j <= i)
    if window > 0:
        ok = ok & (j > i - window)
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs,
                        v.to(torch.float32)).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, Hkv, D] -> [B, S, H, D]: the JAX
    package's ``mha`` without its kernel (kv repeated to H heads, heads
    moved before S, ``attention_ref``, moved back)."""
    rep = q.shape[2] // k.shape[2]
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                        window=window)
    return out.transpose(1, 2)
