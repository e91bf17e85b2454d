"""GQA attention (qk-norm, sliding window) with a full-sequence forward
and a single-step decode: the GQA part of the JAX package's
``models/attention.py``.

KV cache: ``{"k": [B, S_cache, Hkv, hd], "v": [B, S_cache, Hkv, hd]}``, a
ring buffer of ``S_cache = sliding_window`` slots when windowed.

The full-sequence forward goes through the flash-attention kernel
(``kernels.flash_attention.ops.mha``) for every causal or bidirectional
mask it takes; the prefix-LM mask of the VLM is not one of them. Decode
stays plain torch (one query row against the cache), as the JAX package
leaves it to XLA, and writes the step's k and v into the cache in place
(slice assignment where the reference has ``dynamic_update_slice``): no
copy of the cache per step, and the caller's state is updated.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers

NEG_INF = -1e30
MLA_TODO = ("MLA attention (DeepSeek-V2) is not ported yet: ROADMAP "
            "Queue 1 item 10c")

Params = Dict[str, torch.Tensor]


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    if cfg.mla is not None:
        raise NotImplementedError(MLA_TODO)
    hd, d = cfg.resolved_head_dim, cfg.d_model
    p = {
        "w_q": layers.dense_init(generator, d, cfg.n_heads * hd, dtype),
        "w_k": layers.dense_init(generator, d, cfg.n_kv_heads * hd, dtype),
        "w_v": layers.dense_init(generator, d, cfg.n_kv_heads * hd, dtype),
        "w_o": layers.dense_init(generator, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rms_norm_init(hd, dtype, generator.device)
        p["k_norm"] = layers.rms_norm_init(hd, dtype, generator.device)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device: DeviceLike = "cuda") -> Params:
    """A zeroed kv cache on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    if cfg.mla is not None:
        raise NotImplementedError(MLA_TODO)
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, s, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sdpa(q, k, v, mask, scale):
    """q: [B,S,H,hd]; k,v: [B,T,H,hd]; mask: [S,T] additive."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits + mask, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, Hkv, hd] -> [B, T, n_heads, hd], head h from kv head
    h // (n_heads / Hkv) (``jnp.repeat``), by expand and reshape: no host
    sync on the decode path."""
    b, t, n_kv, hd = k.shape
    if n_kv == n_heads:
        return k
    rep = n_heads // n_kv
    return k[:, :, :, None, :].expand(b, t, n_kv, rep, hd) \
        .reshape(b, t, n_heads, hd)


def _qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["w_q"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["w_k"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["w_v"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mask_info: dict
                ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward. Returns (out, kv) where kv feeds cache fill.
    The window applies only under the causal mask, as the reference's
    ``build_mask`` applies it."""
    if mask_info.get("prefix_len", 0):
        raise NotImplementedError(
            "the prefix-LM mask (VLM) is not ported yet: ROADMAP Queue 1 "
            "item 10e")
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    causal = mask_info["causal"]
    window = mask_info.get("window", 0) if causal else 0
    out = flash_ops.mha(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return out @ params["w_o"], {"k": k, "v": v}


def gqa_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               pos: int, cache: Params) -> Tuple[torch.Tensor, Params]:
    """Single-token decode. x_t: [B, d]; pos: the current position (a
    Python int, so the step makes no host sync). Writes the step's k and v
    into ``cache`` in place and returns it.

    The cache is a ring buffer when cfg.sliding_window > 0 (S_cache ==
    window); attention masks out unwritten and out-of-window slots by each
    slot's absolute position."""
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    s_cache = cache["k"].shape[1]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k, v = _qkv(params, cfg, x_t[:, None, :], posv)
    slot = pos % s_cache if cfg.sliding_window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    idx = torch.arange(s_cache, device=x_t.device)
    if cfg.sliding_window:
        wraps = pos // s_cache + (idx <= pos % s_cache).to(idx.dtype)
        abs_pos = (wraps - 1) * s_cache + idx
        valid = (abs_pos >= 0) & (abs_pos <= pos) \
            & (abs_pos > pos - cfg.sliding_window)
    else:
        valid = idx <= pos
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
    out = _sdpa(q, _repeat_kv(cache["k"], cfg.n_heads),
                _repeat_kv(cache["v"], cfg.n_heads), mask, hd ** -0.5)
    return out.reshape(b, cfg.n_heads * hd) @ params["w_o"], cache


def attn_forward(params, cfg, x, positions, mask_info):
    if cfg.mla is not None:
        raise NotImplementedError(MLA_TODO)
    return gqa_forward(params, cfg, x, positions, mask_info)


def attn_decode(params, cfg, x_t, pos, cache):
    if cfg.mla is not None:
        raise NotImplementedError(MLA_TODO)
    return gqa_decode(params, cfg, x_t, pos, cache)
