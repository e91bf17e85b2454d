"""Shared neural-net building blocks: plain functions over dicts of
tensors, in the JAX package's layout (``w [in, out]``, ``x @ w``).

Initialisers draw from an explicit ``torch.Generator`` on the generator's
own device, so full-width weights are drawn where they live. Numbers that
differ from the JAX package on purpose: ``jax.nn.gelu`` defaults to its tanh
approximation, so ``gelu``/``geglu`` use ``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _randn(generator: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) on the generator's device, scaled in place (no second
    copy of a full-width matrix)."""
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """[in_dim, out_dim] weights ~ N(0, scale^2), scale = in_dim**-0.5 by
    default; drawn on the generator's device."""
    scale = scale if scale is not None else in_dim ** -0.5
    return _randn(generator, (in_dim, out_dim), scale, dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    return _randn(generator, (vocab, dim), 0.02, dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean negative log-likelihood over the batch axis (the one before the
    class axis): logits [..., B, V], labels [..., B] int -> [...]. For a
    single model's [B, V] logits it is the JAX package's scalar loss; for
    client-stacked [C, B, V] logits it is the per-client loss [C]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm_init(dim: int, dtype: torch.dtype, device: torch.device
                  ) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (half-rotation convention)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device: torch.device
                     ) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [half]
    angles = positions[..., None].to(torch.float32) * freqs     # [..., s, half]
    cos = torch.cos(angles)[..., None, :]                      # [..., s, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32) -> Params:
    p: Params = {"w_in": dense_init(generator, d_model, d_ff, dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    p["w_out"] = dense_init(generator, d_ff, d_model, dtype)
    return p


def mlp_apply(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ params["w_in"]
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    elif kind == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * h
    elif kind == "squared_relu":
        h = F.relu(h).square()
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Depthwise causal conv (the Mamba block's local mixing)
# ---------------------------------------------------------------------------


def causal_conv_init(generator: torch.Generator, channels: int, width: int,
                     dtype=torch.float32) -> Params:
    return {"w": _randn(generator, (width, channels), width ** -0.5, dtype),
            "b": torch.zeros((channels,), dtype=dtype,
                             device=generator.device)}


def causal_conv_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> depthwise causal conv over T."""
    w = params["w"]                                    # [W, C]
    width, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:t, :] * w[0]
    for i in range(1, width):                          # width is small (4)
        out = out + pad[:, i:i + t, :] * w[i]
    return out + params["b"]


def causal_conv_step(params: Params, conv_state: torch.Tensor,
                     x_t: torch.Tensor):
    """Single decode step. conv_state: [B, W-1, C]; x_t: [B, C]."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, W, C]
    out = (window * params["w"]).sum(dim=1) + params["b"]
    return out, window[:, 1:, :]
