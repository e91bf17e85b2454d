"""A decoder-only transformer and its next-token loss, in plain PyTorch.

Pre-norm blocks of RMSNorm, causal grouped-query attention with rotary
position embeddings (the half-rotation form: the first and second halves
of each head are the pair's two coordinates) and a SwiGLU MLP; a final
RMSNorm and a head tied to the embedding. Weights are laid out as
``x @ w`` (``[in, out]``), each block's leaves stacked on a leading layer
axis. The loss is the mean cross-entropy of every position's next token.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

def leaf_shapes(widths: Mapping) -> Dict[str, tuple]:
    """Every leaf's shape, in a fixed order."""
    d, hd, L = widths["d_model"], widths["head_dim"], widths["n_layers"]
    h, hkv, ff = widths["n_heads"], widths["n_kv_heads"], widths["d_ff"]
    return {
        "embed": (widths["vocab"], d),
        "final_norm": (d,),
        "attn_norm": (L, d),
        "wq": (L, d, h * hd),
        "wk": (L, d, hkv * hd),
        "wv": (L, d, hkv * hd),
        "wo": (L, h * hd, d),
        "mlp_norm": (L, d),
        "w_gate": (L, d, ff),
        "w_up": (L, d, ff),
        "w_down": (L, ff, d),
    }


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; position s turns pair i by s * theta**(-2i / D)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(x: torch.Tensor, w: Weights, l: int, widths: Mapping
              ) -> torch.Tensor:
    """Causal attention of layer ``l``; query head i reads kv head
    i // (n_heads / n_kv_heads)."""
    b, s, _ = x.shape
    h, hkv, hd = widths["n_heads"], widths["n_kv_heads"], widths["head_dim"]
    q = rotary((x @ w["wq"][l]).view(b, s, h, hd), widths["rope_theta"])
    k = rotary((x @ w["wk"][l]).view(b, s, hkv, hd), widths["rope_theta"])
    v = (x @ w["wv"][l]).view(b, s, hkv, hd)
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = scores.masked_fill(future, float("-inf")).softmax(-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return out @ w["wo"][l]


def loss(w: Weights, widths: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S + 1]: positions
    0 .. S-1 are read, 1 .. S predicted."""
    eps = widths["norm_eps"]
    x = w["embed"][tokens[:, :-1]]
    for l in range(widths["n_layers"]):
        x = x + attention(rms_norm(x, w["attn_norm"][l], eps), w, l, widths)
        y = rms_norm(x, w["mlp_norm"][l], eps)
        x = x + (F.silu(y @ w["w_gate"][l]) * (y @ w["w_up"][l])) \
            @ w["w_down"][l]
    logits = rms_norm(x, w["final_norm"], eps) @ w["embed"].T
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
