"""Attention: GQA (qk-norm, sliding window, prefix-LM mask) and
DeepSeek-style MLA, each with a full-sequence forward and a single-step
decode (the JAX package's ``models/attention.py``).

KV caches:
  GQA: ``{"k": [B, S_cache, Hkv, hd], "v": [B, S_cache, Hkv, hd]}``, a
       ring buffer of ``S_cache = sliding_window`` slots when windowed;
  MLA: ``{"ckv": [B, S_cache, kv_lora], "k_rope": [B, S_cache, rope_dim]}``.

The full-sequence forward goes through the flash-attention kernel
(``kernels.flash_attention.ops.mha``) for every mask the reference's
``build_mask`` makes: causal, bidirectional, windowed, and the VLM's
prefix-LM mask (``mask_info["prefix_len"]``: the image positions attend
to each other both ways, the text causally). MLA's
forward reconstructs per-head keys and values from the latent and runs
the kernel at head dim hd + rope (keys and queries concatenated with their
rope parts, values zero-padded), the reference's materialized form; its
absorbed form (scores in the latent space) is the ``absorbed=True``
ablation. Decode stays plain torch (one query row against the cache), as
the JAX package leaves it to XLA; MLA decodes in the absorbed form. Decode
writes the step's entries into the cache in place (slice assignment where
the reference has ``dynamic_update_slice``): no copy of the cache per
step, and the caller's state is updated.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import layers

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    hd, d, h = cfg.resolved_head_dim, cfg.d_model, cfg.n_heads
    dev = generator.device

    def dense(din, dout):
        return layers.dense_init(generator, din, dout, dtype, lead=lead)

    if cfg.mla is not None:
        m = cfg.mla
        p = {"w_dkv": dense(d, m.kv_lora + m.rope_dim),
             "kv_norm": layers.rms_norm_init(m.kv_lora, dtype, dev, lead),
             "w_uk": dense(m.kv_lora, h * hd),
             "w_uv": dense(m.kv_lora, h * hd),
             "w_o": dense(h * hd, d)}
        if m.q_lora:
            p["w_dq"] = dense(d, m.q_lora)
            p["q_norm"] = layers.rms_norm_init(m.q_lora, dtype, dev, lead)
            p["w_uq"] = dense(m.q_lora, h * (hd + m.rope_dim))
        else:
            p["w_uq"] = dense(d, h * (hd + m.rope_dim))
        return p
    p = {"w_q": dense(d, h * hd),
         "w_k": dense(d, cfg.n_kv_heads * hd),
         "w_v": dense(d, cfg.n_kv_heads * hd),
         "w_o": dense(h * hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = layers.rms_norm_init(hd, dtype, dev, lead)
        p["k_norm"] = layers.rms_norm_init(hd, dtype, dev, lead)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device: DeviceLike = "cuda") -> Params:
    """A zeroed kv cache on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    device = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, s, m.kv_lora), dtype=dtype,
                                   device=device),
                "k_rope": torch.zeros((batch, s, m.rope_dim), dtype=dtype,
                                      device=device)}
    shape = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
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


def _heads(par, x: torch.Tensor, w: torch.Tensor, n_heads: int, hd: int,
           gather: bool) -> Tuple[torch.Tensor, int]:
    """(x @ w as heads [B, S, h, hd], the first head's index). Under
    ``par`` ``w`` may be a column block over the model axes: its heads
    are this rank's block of ``n_heads`` unless ``gather``, or unless the
    block cuts a head, in which case the columns are gathered over the
    model axes first (all heads)."""
    b, s, _ = x.shape
    y = x @ w
    lo = 0
    if par is not None and y.shape[-1] < n_heads * hd:
        if gather or y.shape[-1] % hd:
            y = par.gather_model(y, -1)
        else:
            lo = par.model_index * (y.shape[-1] // hd)
    return y.reshape(b, s, -1, hd), lo


def _qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, par=None, gather_q: bool = False,
         gather_kv: bool = False):
    """(q, k, v, index of q's first head, index of k's first head).
    Without ``par`` every head; under it each projection's heads as
    :func:`_heads` gives them (``gather_q`` / ``gather_kv``: all).

    When ``w_q`` is a column block the attention runs tensor-parallel:
    ``x`` enters the column blocks once (``par.enter_model``), and so does
    every replicated leaf read inside them (a whole ``w_k`` / ``w_v``, the
    qk-norm scales), whose gradient each rank holds in part."""
    hd = cfg.resolved_head_dim
    tp = par is not None and params["w_q"].shape[-1] < cfg.n_heads * hd
    enter = par.enter_model if tp else (lambda t: t)
    x = enter(x)

    def weight(name, n):
        w = params[name]
        return enter(w) if w.shape[-1] == n * hd else w

    q, q_lo = _heads(par, x, params["w_q"], cfg.n_heads, hd, gather_q)
    k, kv_lo = _heads(par, x, weight("w_k", cfg.n_kv_heads),
                      cfg.n_kv_heads, hd, gather_kv)
    v, _ = _heads(par, x, weight("w_v", cfg.n_kv_heads), cfg.n_kv_heads,
                  hd, gather_kv)
    if cfg.qk_norm:
        q = layers.rms_norm({"scale": enter(params["q_norm"]["scale"])}, q,
                            cfg.norm_eps)
        k = layers.rms_norm({"scale": enter(params["k_norm"]["scale"])}, k,
                            cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, q_lo, kv_lo


def _kv_for(k: torch.Tensor, kv_lo: int, q_lo: int, hq: int,
            rep: int) -> torch.Tensor:
    """The kv heads that query heads ``[q_lo, q_lo + hq)`` read, from
    ``k`` [B, T, h, hd] holding kv heads from ``kv_lo`` on (query head
    ``i`` reads kv head ``i // rep``): a slice whose GQA grouping the
    flash kernel and ``_repeat_kv`` keep, else one kv head a query
    head."""
    g0, g1 = q_lo // rep, (q_lo + hq - 1) // rep + 1
    k = k[:, :, g0 - kv_lo:g1 - kv_lo]
    if g1 - g0 == 1 or (q_lo % rep == 0 and hq % rep == 0):
        return k
    first = q_lo - g0 * rep
    return _repeat_kv(k, (g1 - g0) * rep)[:, :, first:first + hq]


def _out_proj(par, cfg: ModelConfig, out: torch.Tensor, q_lo: int,
              w_o: torch.Tensor) -> torch.Tensor:
    """``out`` (the attention output of query heads from ``q_lo`` on,
    [..., h * hd]) times ``w_o``. A row block of ``w_o`` (its contraction
    dim split over the model axes) takes this rank's columns of ``out``
    and the partial products are summed over the model axes; a whole
    ``w_o`` has every head in ``out``."""
    rows = w_o.shape[0]
    if par is not None and rows < cfg.n_heads * cfg.resolved_head_dim:
        c0 = par.model_index * rows - q_lo * cfg.resolved_head_dim
        return par.sum_model(out[..., c0:c0 + rows] @ w_o)
    return out @ w_o


def _flash_mask(mask_info: dict) -> dict:
    """The mask keywords of ``flash_ops.mha`` for the model's symbolic mask
    (``{"causal", "prefix_len", "window"}``): the window and the prefix
    only under the causal mask, as ``build_mask`` reads them."""
    causal = mask_info["causal"]
    return {"causal": causal,
            "window": mask_info.get("window", 0) if causal else 0,
            "prefix_len": mask_info.get("prefix_len", 0) if causal else 0}


def _check_position(pos: int, capacity: int) -> None:
    if not 0 <= pos < capacity:
        raise ValueError(f"decode position {pos} is outside the KV cache, "
                         f"whose capacity is {capacity} positions")


def gqa_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mask_info: dict, par=None
                ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward. Returns (out, kv) where kv feeds cache fill.
    The window and the prefix apply only under the causal mask, as the
    reference's ``build_mask`` applies them. Under ``par`` (tensor
    parallel: ``models/parallel.py``) the flash kernel runs on this rank's
    query heads and the kv heads they read, and kv holds this rank's kv
    heads (every kv head where their columns were gathered)."""
    b, s, _ = x.shape
    q, k, v, q_lo, kv_lo = _qkv(params, cfg, x, positions, par)
    kq, vq = k, v
    if q.shape[2] < cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        kq = _kv_for(k, kv_lo, q_lo, q.shape[2], rep)
        vq = _kv_for(v, kv_lo, q_lo, q.shape[2], rep)
    out = flash_ops.mha(q, kq, vq, **_flash_mask(mask_info))
    out = out.reshape(b, s, q.shape[2] * cfg.resolved_head_dim)
    return _out_proj(par, cfg, out, q_lo, params["w_o"]), {"k": k, "v": v}


def _valid_slots(cfg: ModelConfig, pos: int, idx: torch.Tensor,
                 s_cache: int) -> torch.Tensor:
    """Which of the cache slots ``idx`` hold a position the token at
    ``pos`` attends to: a ring of ``s_cache`` slots under a window, else
    the positions up to ``pos``."""
    if cfg.sliding_window:
        wraps = pos // s_cache + (idx <= pos % s_cache).to(idx.dtype)
        abs_pos = (wraps - 1) * s_cache + idx
        return (abs_pos >= 0) & (abs_pos <= pos) \
            & (abs_pos > pos - cfg.sliding_window)
    return idx <= pos


def gqa_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               pos: int, cache: Params, par=None
               ) -> Tuple[torch.Tensor, Params]:
    """Single-token decode. x_t: [B, d]; pos: the current position (a
    Python int, so the step makes no host sync). Writes the step's k and v
    into ``cache`` in place and returns it.

    The cache is a ring buffer when cfg.sliding_window > 0 (S_cache ==
    window); attention masks out unwritten and out-of-window slots by each
    slot's absolute position. An unwindowed cache holds positions below
    its capacity: a later ``pos`` raises ``ValueError`` before any write
    (the reference clamps the write onto the last slot). Under ``par``
    see :func:`_gqa_decode_par`."""
    if par is not None and (par.model_axes or par.seq_axes):
        return _gqa_decode_par(params, cfg, x_t, pos, cache, par)
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    s_cache = cache["k"].shape[1]
    if not cfg.sliding_window:
        _check_position(pos, s_cache)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k, v, _, _ = _qkv(params, cfg, x_t[:, None, :], posv)
    slot = pos % s_cache if cfg.sliding_window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    valid = _valid_slots(cfg, pos, torch.arange(s_cache, device=x_t.device),
                         s_cache)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
    out = _sdpa(q, _repeat_kv(cache["k"], cfg.n_heads),
                _repeat_kv(cache["v"], cfg.n_heads), mask, hd ** -0.5)
    return out.reshape(b, cfg.n_heads * hd) @ params["w_o"], cache


def _sdpa_blocks(q, k, v, valid, scale, par):
    """Attention of q [B, 1, H, hd] over the positions split into blocks
    over ``par.seq_axes``: this rank's block k, v [B, T, H, hd] with its
    ``valid`` slots [T]. Each rank's softmax over its block gives an
    output and a log-sum-exp, and the blocks' partials combine exactly
    (weights ``exp(lse_r - lse)``; a block with no valid slot weighs
    0). The partials are gathered and combined in fp32, whatever the
    cache's dtype, and the result cast back to it."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * scale
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l_sum = p.sum(-1, keepdim=True)                          # [B, H, 1, 1]
    out = torch.einsum("bhst,bthd->bshd", p / l_sum.clamp_min(1e-30),
                       v.to(torch.float32))
    lse = torch.where(l_sum > 0, m + torch.log(l_sum),
                      torch.full_like(m, float("-inf")))
    both = par.gather_seq(torch.cat([out, lse.permute(0, 2, 1, 3)], dim=-1))
    outs, lses = both[..., :-1], both[..., -1:]
    w = torch.exp(lses - torch.logsumexp(lses, dim=0, keepdim=True))
    return (w * outs).sum(0).to(v.dtype)


def _gqa_decode_par(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                    pos: int, cache: Params, par
                    ) -> Tuple[torch.Tensor, Params]:
    """:func:`gqa_decode` on a mesh. The cache holds every kv head, so the
    step's k and v are gathered over the model axes. With the cache's
    positions split over ``par.seq_axes`` (each rank one block of slots)
    the query of every head is gathered too, only the rank holding slot
    ``pos`` (``pos % S_cache`` under a window) writes it, each rank
    attends over its block and the partials combine exactly
    (:func:`_sdpa_blocks`); the output is then cut back to this rank's
    heads for the row block of ``w_o``. With every position on every rank
    each rank attends for its own query heads."""
    b = x_t.shape[0]
    hd = cfg.resolved_head_dim
    s_block = cache["k"].shape[1]
    s_cache = s_block * par.seq_extent
    if not cfg.sliding_window:
        _check_position(pos, s_cache)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q, k, v, q_lo, _ = _qkv(params, cfg, x_t[:, None, :], posv, par,
                            gather_q=bool(par.seq_axes), gather_kv=True)
    owner, slot = divmod(pos % s_cache if cfg.sliding_window else pos,
                         s_block)
    if owner == par.seq_index:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
    idx = par.seq_index * s_block + torch.arange(s_block, device=x_t.device)
    valid = _valid_slots(cfg, pos, idx, s_cache)
    hq = q.shape[2]
    rep = cfg.n_heads // cfg.n_kv_heads
    kq = _repeat_kv(_kv_for(cache["k"], 0, q_lo, hq, rep), hq)
    vq = _repeat_kv(_kv_for(cache["v"], 0, q_lo, hq, rep), hq)
    if par.seq_axes:
        out = _sdpa_blocks(q, kq, vq, valid, hd ** -0.5, par)
    else:
        mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
        out = _sdpa(q, kq, vq, mask, hd ** -0.5)
    return _out_proj(par, cfg, out.reshape(b, hq * hd), q_lo,
                     params["w_o"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def _mla_q(params: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    b, s, _ = x.shape
    hd, m = cfg.resolved_head_dim, cfg.mla
    if m.q_lora:
        x = layers.rms_norm(params["q_norm"], x @ params["w_dq"],
                            cfg.norm_eps)
    q = (x @ params["w_uq"]).reshape(b, s, cfg.n_heads, hd + m.rope_dim)
    q_rope = layers.apply_rope(q[..., hd:], positions, cfg.rope_theta)
    return q[..., :hd], q_rope


def _mla_kv(params: Params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    ckv = layers.rms_norm(params["kv_norm"], dkv[..., :m.kv_lora],
                          cfg.norm_eps)
    k_rope = layers.apply_rope(dkv[..., None, m.kv_lora:], positions,
                               cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def _mla_attend(params: Params, cfg: ModelConfig, q_nope, q_rope, ckv,
                k_rope, mask):
    """Latent-space attention, W_uk absorbed into the query and W_uv
    applied after the values. q_nope: [B,S,H,hd]; q_rope: [B,S,H,r]; ckv:
    [B,T,kv_lora]; k_rope: [B,T,r]; mask: [S,T] additive."""
    b, s, h, hd = q_nope.shape
    m = cfg.mla
    w_uk = params["w_uk"].reshape(m.kv_lora, h, hd)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, w_uk)
    scores = torch.einsum("bshl,btl->bhst", q_lat, ckv) \
        + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    scores = scores.to(torch.float32) * (hd + m.rope_dim) ** -0.5 + mask
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhst,btl->bshl", probs, ckv)
    w_uv = params["w_uv"].reshape(m.kv_lora, h, hd)
    out = torch.einsum("bshl,lhd->bshd", o_lat, w_uv)
    return out.reshape(b, s, h * hd) @ params["w_o"]


def _mla_attend_materialized(params: Params, cfg: ModelConfig, q_nope,
                             q_rope, ckv, k_rope, mask_info: dict):
    """Prefill form: per-head keys and values reconstructed from the
    latent once, then the flash kernel at head dim hd + rope, its scale
    1/sqrt(hd + rope) the reference's; values zero-padded to that dim and
    the padding sliced off the output."""
    b, s, h, hd = q_nope.shape
    r = cfg.mla.rope_dim
    k_nope = (ckv @ params["w_uk"]).reshape(b, s, h, hd)
    v = (ckv @ params["w_uv"]).reshape(b, s, h, hd)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, r)],
                      dim=-1)
    del k_nope
    v_pad = F.pad(v, (0, r))
    del v
    out = flash_ops.mha(q_cat, k_cat, v_pad, **_flash_mask(mask_info))
    return out[..., :hd].reshape(b, s, h * hd) @ params["w_o"]


def _dense_mask(s: int, mask_info: dict, device) -> torch.Tensor:
    """[S, S] additive mask (0 or NEG_INF), the reference's ``build_mask``
    (``flash_attention.ref.keep_mask`` under ``_flash_mask``'s rules)."""
    ok = flash_ref.keep_mask(s, **_flash_mask(mask_info), device=device)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def mla_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mask_info: dict, *,
                absorbed: bool = False) -> Tuple[torch.Tensor, Params]:
    """Full-sequence MLA. Returns (out, the latent cache entries). The
    default is the materialized form on the flash kernel; ``absorbed``
    takes the latent-space form with a dense mask (plain torch), the
    reference's ablation, which it selects by ``REPRO_MLA_ABSORBED``."""
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, k_rope = _mla_kv(params, cfg, x, positions)
    if absorbed:
        mask = _dense_mask(x.shape[1], mask_info, x.device)
        out = _mla_attend(params, cfg, q_nope, q_rope, ckv, k_rope, mask)
    else:
        out = _mla_attend_materialized(params, cfg, q_nope, q_rope, ckv,
                                       k_rope, mask_info)
    return out, {"ckv": ckv, "k_rope": k_rope}


def mla_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               pos: int, cache: Params) -> Tuple[torch.Tensor, Params]:
    """Single-token MLA decode in the absorbed form. x_t: [B, d]; pos: the
    current position (a Python int). Writes the step's latent and rope key
    into ``cache`` in place and returns it; a ``pos`` past the cache's
    capacity raises ``ValueError`` before any write (the reference clamps
    the write onto the last slot)."""
    b = x_t.shape[0]
    t = cache["ckv"].shape[1]
    _check_position(pos, t)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope = _mla_q(params, cfg, x_t[:, None, :], posv)
    ckv_t, k_rope_t = _mla_kv(params, cfg, x_t[:, None, :], posv)
    cache["ckv"][:, pos] = ckv_t[:, 0]
    cache["k_rope"][:, pos] = k_rope_t[:, 0]
    valid = torch.arange(t, device=x_t.device) <= pos
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
    out = _mla_attend(params, cfg, q_nope, q_rope, cache["ckv"],
                      cache["k_rope"], mask)
    return out[:, 0, :], cache


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def attn_forward(params, cfg, x, positions, mask_info, par=None):
    """``par``: the tensor-parallel context (GQA only: the step builder
    refuses MLA leaves split over an axis of extent > 1)."""
    if cfg.mla is not None:
        return mla_forward(params, cfg, x, positions, mask_info)
    return gqa_forward(params, cfg, x, positions, mask_info, par)


def attn_decode(params, cfg, x_t, pos, cache, par=None):
    if cfg.mla is not None:
        return mla_decode(params, cfg, x_t, pos, cache)
    return gqa_decode(params, cfg, x_t, pos, cache, par)
