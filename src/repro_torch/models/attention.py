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
the JAX package leaves it to XLA; MLA decodes in the absorbed form. On a
mesh (``par``, ``models/parallel.py``) GQA and MLA run on this rank's
heads, and a decode cache split on its positions combines the blocks'
partial softmaxes exactly (:func:`_softmax_blocks`). Decode
writes the step's entries into the cache in place (slice assignment where
the reference has ``dynamic_update_slice``): no copy of the cache per
step, and the caller's state is updated.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_traced
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
    device = resolve_traced(device)
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
    ``valid`` slots [T] (:func:`_softmax_blocks`), cast back to the
    cache's dtype."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * scale
    return _softmax_blocks(logits, valid, lambda p: torch.einsum(
        "bhst,bthd->bshd", p, v.to(torch.float32)), par).to(v.dtype)


def _softmax_blocks(logits, valid, values, par):
    """The softmax over every position block of ``logits`` [B, H, S, T]
    (fp32, scaled; this rank's block of T positions, ``valid`` [T]) times
    the values: ``values(p)`` gives [B, S, H, dv] of this block's
    probabilities p. Each rank's softmax over its block gives an output
    and a log-sum-exp, and the blocks' partials combine exactly (weights
    ``exp(lse_r - lse)``; a block with no valid slot weighs 0). The
    partials are gathered (``par.gather_seq``) and combined in fp32,
    whatever the cache's dtype; returns fp32."""
    logits = logits.masked_fill(~valid, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l_sum = p.sum(-1, keepdim=True)                          # [B, H, S, 1]
    out = values(p / l_sum.clamp_min(1e-30))
    lse = torch.where(l_sum > 0, m + torch.log(l_sum),
                      torch.full_like(m, float("-inf")))
    both = par.gather_seq(torch.cat([out, lse.permute(0, 2, 1, 3)], dim=-1))
    outs, lses = both[..., :-1], both[..., -1:]
    w = torch.exp(lses - torch.logsumexp(lses, dim=0, keepdim=True))
    return (w * outs).sum(0)


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


def _mla_tp(params: Params, cfg: ModelConfig, par) -> bool:
    """Whether an MLA block runs tensor-parallel: ``w_o`` a row block over
    the model axes (its head blocks' output a partial sum)."""
    return par is not None \
        and params["w_o"].shape[0] < cfg.n_heads * cfg.resolved_head_dim


def _mla_heads(par, w: torch.Tensor, n_heads: int, width: int, tp: bool,
               every: bool) -> Tuple[torch.Tensor, int]:
    """(``w`` [rows, h * width] as heads [rows, h, width], the first
    head's index). A column block of whole heads gives this rank's heads
    unless ``every``; a block that cuts a head, or any block when
    ``every``, is gathered over the model axes (every head: a weight of
    at most the latent's rows, read where a block would cut a head); a
    whole leaf gives every head and, under ``tp``, enters the split block
    (its gradient, partial on each rank, is summed)."""
    rows, cols = w.shape
    if cols < n_heads * width:
        if not every and cols % width == 0:
            return (w.reshape(rows, cols // width, width),
                    par.model_index * (cols // width))
        w = par.gather_model(w, -1) if tp else par.gather_whole(w, -1)
    elif tp:
        w = par.enter_model(w)
    return w.reshape(rows, n_heads, width), 0


def _mla_q(params: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, par=None, tp: bool = False):
    """(q_nope [B, S, h, hd], q_rope [B, S, h, r], first head): every
    head, or under ``tp`` this rank's block (every head where ``w_uq``'s
    block would cut one). The q-lora latent (or ``x``) enters the column
    block under ``tp``."""
    b, s, _ = x.shape
    hd, m = cfg.resolved_head_dim, cfg.mla
    if m.q_lora:
        x = layers.rms_norm(params["q_norm"], x @ params["w_dq"],
                            cfg.norm_eps)
    if tp:
        x = par.enter_model(x)
    w, lo = _mla_heads(par, params["w_uq"], cfg.n_heads, hd + m.rope_dim,
                       tp, not tp)
    q = (x @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1],
                                                hd + m.rope_dim)
    q_rope = layers.apply_rope(q[..., hd:], positions, cfg.rope_theta)
    return q[..., :hd], q_rope, lo


def _mla_kv(params: Params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    ckv = layers.rms_norm(params["kv_norm"], dkv[..., :m.kv_lora],
                          cfg.norm_eps)
    k_rope = layers.apply_rope(dkv[..., None, m.kv_lora:], positions,
                               cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def _mla_up(params: Params, cfg: ModelConfig, name: str, par, tp: bool,
            q_lo: int, h: int) -> torch.Tensor:
    """``w_uk`` / ``w_uv`` at the query heads ``[q_lo, q_lo + h)``:
    [kv_lora, h, hd]."""
    w, lo = _mla_heads(par, params[name], cfg.n_heads,
                       cfg.resolved_head_dim, tp, h == cfg.n_heads)
    return w[:, q_lo - lo:q_lo - lo + h]


def _mla_attend(params: Params, cfg: ModelConfig, q_nope, q_rope, ckv,
                k_rope, mask, par=None, tp: bool = False, q_lo: int = 0):
    """Latent-space attention, W_uk absorbed into the query and W_uv
    applied after the values. q_nope: [B,S,h,hd] (heads from ``q_lo``);
    q_rope: [B,S,h,r]; ckv: [B,T,kv_lora]; k_rope: [B,T,r]; mask: [S,T]
    additive."""
    b, s, h, hd = q_nope.shape
    m = cfg.mla
    w_uk = _mla_up(params, cfg, "w_uk", par, tp, q_lo, h)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, w_uk)
    scores = torch.einsum("bshl,btl->bhst", q_lat, ckv) \
        + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    scores = scores.to(torch.float32) * (hd + m.rope_dim) ** -0.5 + mask
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhst,btl->bshl", probs, ckv)
    w_uv = _mla_up(params, cfg, "w_uv", par, tp, q_lo, h)
    out = torch.einsum("bshl,lhd->bshd", o_lat, w_uv)
    return _out_proj(par if tp else None, cfg, out.reshape(b, s, h * hd),
                     q_lo, params["w_o"])


def _mla_attend_materialized(params: Params, cfg: ModelConfig, q_nope,
                             q_rope, ckv, k_rope, mask_info: dict, par=None,
                             tp: bool = False, q_lo: int = 0):
    """Prefill form: per-head keys and values reconstructed from the
    latent once, then the flash kernel at head dim hd + rope, its scale
    1/sqrt(hd + rope) the reference's; values zero-padded to that dim and
    the padding sliced off the output. The heads are q's (from
    ``q_lo``)."""
    b, s, h, hd = q_nope.shape
    r = cfg.mla.rope_dim
    w_uk = _mla_up(params, cfg, "w_uk", par, tp, q_lo, h)
    k_nope = (ckv @ w_uk.reshape(w_uk.shape[0], -1)).reshape(b, s, h, hd)
    w_uv = _mla_up(params, cfg, "w_uv", par, tp, q_lo, h)
    v = (ckv @ w_uv.reshape(w_uv.shape[0], -1)).reshape(b, s, h, hd)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, r)],
                      dim=-1)
    del k_nope
    v_pad = F.pad(v, (0, r))
    del v
    out = flash_ops.mha(q_cat, k_cat, v_pad, **_flash_mask(mask_info))
    return _out_proj(par if tp else None, cfg,
                     out[..., :hd].reshape(b, s, h * hd), q_lo,
                     params["w_o"])


def _dense_mask(s: int, mask_info: dict, device) -> torch.Tensor:
    """[S, S] additive mask (0 or NEG_INF), the reference's ``build_mask``
    (``flash_attention.ref.keep_mask`` under ``_flash_mask``'s rules)."""
    ok = flash_ref.keep_mask(s, **_flash_mask(mask_info), device=device)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def mla_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mask_info: dict, par=None, *,
                absorbed: bool = False) -> Tuple[torch.Tensor, Params]:
    """Full-sequence MLA. Returns (out, the latent cache entries). The
    default is the materialized form on the flash kernel; ``absorbed``
    takes the latent-space form with a dense mask (plain torch), the
    reference's ablation, which it selects by ``REPRO_MLA_ABSORBED``.
    Under ``par`` with ``w_o`` a row block (:func:`_mla_tp`) either form
    runs on this rank's heads: the latents (``ckv``, ``k_rope``, the
    q-lora latent) are computed whole on every rank and enter the head
    blocks, and ``w_o``'s partial sum is summed over the model axes; the
    cache entries are the whole latents."""
    tp = _mla_tp(params, cfg, par)
    q_nope, q_rope, q_lo = _mla_q(params, cfg, x, positions, par, tp)
    ckv, k_rope = _mla_kv(params, cfg, x, positions)
    ckv_in, k_rope_in = ((par.enter_model(ckv), par.enter_model(k_rope))
                         if tp else (ckv, k_rope))
    if absorbed:
        mask = _dense_mask(x.shape[1], mask_info, x.device)
        out = _mla_attend(params, cfg, q_nope, q_rope, ckv_in, k_rope_in,
                          mask, par, tp, q_lo)
    else:
        out = _mla_attend_materialized(params, cfg, q_nope, q_rope, ckv_in,
                                       k_rope_in, mask_info, par, tp, q_lo)
    return out, {"ckv": ckv, "k_rope": k_rope}


def mla_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               pos: int, cache: Params, par=None
               ) -> Tuple[torch.Tensor, Params]:
    """Single-token MLA decode in the absorbed form. x_t: [B, d]; pos: the
    current position (a Python int). Writes the step's latent and rope key
    into ``cache`` in place and returns it. Under a sliding window the
    latent cache is a ring buffer of ``window`` slots, as GQA's
    (:func:`gqa_decode`; the reference writes MLA's cache at ``pos``,
    clamped onto its last slot); an unwindowed cache holds positions below
    its capacity, and a later ``pos`` raises ``ValueError`` before any
    write. Under ``par`` see :func:`_mla_decode_par`."""
    if par is not None and (_mla_tp(params, cfg, par) or par.seq_axes):
        return _mla_decode_par(params, cfg, x_t, pos, cache, par)
    b = x_t.shape[0]
    t = cache["ckv"].shape[1]
    if not cfg.sliding_window:
        _check_position(pos, t)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope, _ = _mla_q(params, cfg, x_t[:, None, :], posv, par)
    ckv_t, k_rope_t = _mla_kv(params, cfg, x_t[:, None, :], posv)
    slot = pos % t if cfg.sliding_window else pos
    cache["ckv"][:, slot] = ckv_t[:, 0]
    cache["k_rope"][:, slot] = k_rope_t[:, 0]
    valid = _valid_slots(cfg, pos, torch.arange(t, device=x_t.device), t)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
    out = _mla_attend(params, cfg, q_nope, q_rope, cache["ckv"],
                      cache["k_rope"], mask, par)
    return out[:, 0, :], cache


def _mla_decode_par(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                    pos: int, cache: Params, par
                    ) -> Tuple[torch.Tensor, Params]:
    """:func:`mla_decode` on a mesh. Every rank computes the step's
    latent and rope key whole. With the cache's positions split over
    ``par.seq_axes`` (each rank one block of slots) every head's absorbed
    query (``q_nope W_uk``) and rope query are gathered over the model
    axes, only the rank holding slot ``pos`` (``pos % S_cache`` under a
    window) writes it, each rank attends over its block in the latent
    space and the blocks' partials combine exactly
    (:func:`_softmax_blocks`); the latent output is then cut back to this
    rank's heads for ``w_uv`` and ``w_o``'s row block. With every position
    on every rank each rank attends for its own heads."""
    b = x_t.shape[0]
    hd, m = cfg.resolved_head_dim, cfg.mla
    tp = _mla_tp(params, cfg, par)
    s_block = cache["ckv"].shape[1]
    s_cache = s_block * par.seq_extent
    if not cfg.sliding_window:
        _check_position(pos, s_cache)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope, q_lo = _mla_q(params, cfg, x_t[:, None, :], posv, par,
                                  tp)
    ckv_t, k_rope_t = _mla_kv(params, cfg, x_t[:, None, :], posv)
    owner, slot = divmod(pos % s_cache if cfg.sliding_window else pos,
                         s_block)
    if owner == par.seq_index:
        cache["ckv"][:, slot] = ckv_t[:, 0]
        cache["k_rope"][:, slot] = k_rope_t[:, 0]
    idx = par.seq_index * s_block + torch.arange(s_block, device=x_t.device)
    valid = _valid_slots(cfg, pos, idx, s_cache)
    if not par.seq_axes:
        mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, :]
        out = _mla_attend(params, cfg, q_nope, q_rope, cache["ckv"],
                          cache["k_rope"], mask, par, tp, q_lo)
        return out[:, 0, :], cache
    h = q_nope.shape[2]
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope,
                         _mla_up(params, cfg, "w_uk", par, tp, q_lo, h))
    if h < cfg.n_heads:     # every head's queries
        q_lat = par.gather_model(q_lat, 2)
        q_rope = par.gather_model(q_rope, 2)
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    scores = torch.einsum("bshl,btl->bhst", q_lat, ckv) \
        + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    o_lat = _softmax_blocks(
        scores.to(torch.float32) * (hd + m.rope_dim) ** -0.5, valid,
        lambda p: torch.einsum("bhst,btl->bshl", p, ckv.to(torch.float32)),
        par).to(ckv.dtype)[:, :, q_lo:q_lo + h]
    out = torch.einsum("bshl,lhd->bshd", o_lat,
                       _mla_up(params, cfg, "w_uv", par, tp, q_lo, h))
    return _out_proj(par if tp else None, cfg, out.reshape(b, h * hd),
                     q_lo, params["w_o"]), cache


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def attn_forward(params, cfg, x, positions, mask_info, par=None):
    """``par``: the tensor-parallel context (``models/parallel.py``)."""
    if cfg.mla is not None:
        return mla_forward(params, cfg, x, positions, mask_info, par)
    return gqa_forward(params, cfg, x, positions, mask_info, par)


def attn_decode(params, cfg, x_t, pos, cache, par=None):
    if cfg.mla is not None:
        return mla_decode(params, cfg, x_t, pos, cache, par)
    return gqa_decode(params, cfg, x_t, pos, cache, par)
