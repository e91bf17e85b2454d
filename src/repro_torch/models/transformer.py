"""The serving part of the JAX package's ``models/transformer.py``: decoder
LMs and the hybrid Mamba/attention stack, with a full forward, prefill and
a cached decode step.

Layer layout and params are the reference's: ``n_dense_prefix`` unrolled
blocks (``params["prefix"]``), then the remaining layers grouped into
periods of ``cfg.pattern``, each pattern position ``j`` holding its blocks'
params stacked over periods (``params["period"]["j<j>"]``, leaves
``[n_per, ...]``), so weights carry across leaf for leaf
(``weights.lm_params_from_jax``). Where the reference scans over periods,
the port runs a Python loop and indexes period ``p`` of every leaf (a view).

Block kinds ``attn`` (GQA) and ``ssm`` with dense MLPs are ported. MoE,
MLA, ``mlstm``/``slstm``, the VLM patch prefix and the audio frontend
raise NotImplementedError naming the ROADMAP item that ports them.

Public API:
  init_lm(generator, cfg, dtype)                   -> params
  forward(params, cfg, x, want_cache=...)          -> (hidden, caches)
  prefill(params, cfg, batch, max_len=...)         -> (logits_last, state)
  decode_step(params, cfg, state, token, pos)      -> (logits, state)
  init_decode_state(cfg, batch, max_len, ...)      -> state

``decode_step`` updates ``state`` in place (the attention caches by slice
assignment, the recurrent states by ``copy_``) and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention, layers, ssm as ssm_lib

Params = Dict[str, Any]

# what is not ported yet, and the ROADMAP item (Queue 1) that ports it
_TODO = {
    "moe": "MoE MLPs (models/moe.py) are not ported yet: ROADMAP Queue 1 "
           "item 10b",
    "mla": attention.MLA_TODO,
    "xlstm": "mLSTM/sLSTM blocks (models/xlstm.py) are not ported yet: "
             "ROADMAP Queue 1 item 10d",
    "frontend": "the VLM patch prefix and the audio frontend are not ported "
                "yet: ROADMAP Queue 1 item 10e",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config that needs an unported part."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {_TODO['moe']}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: {_TODO['mla']}")
    if {"mlstm", "slstm"} & set(cfg.pattern):
        raise NotImplementedError(f"{cfg.name}: {_TODO['xlstm']}")
    if cfg.family == "vlm" or cfg.audio_frontend:
        raise NotImplementedError(f"{cfg.name}: {_TODO['frontend']}")


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------


def _n_periods(cfg: ModelConfig) -> int:
    body = cfg.n_layers - cfg.n_dense_prefix
    pat = len(cfg.pattern)
    if body % pat:
        raise ValueError(f"{cfg.name}: {body} layers not divisible by "
                         f"pattern {pat}")
    return body // pat


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _period(tree: Params, p: int) -> Params:
    """Period p of a period-stacked tree (views)."""
    return _tree_map(lambda x: x[p], tree)


def _stack(trees: List[Params]) -> Params:
    """Stack trees leaf by leaf on a new leading period axis; one period
    becomes a view (no second copy of a full-width block)."""
    if len(trees) == 1:
        return _tree_map(lambda x: x.unsqueeze(0), trees[0])
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
                dtype) -> Params:
    init = attention.init_attention if kind == "attn" else ssm_lib.init_ssm
    dev = generator.device
    p: Params = {"norm1": layers.rms_norm_init(cfg.d_model, dtype, dev),
                 "mixer": init(generator, cfg, dtype)}
    if cfg.d_ff > 0:
        p["norm2"] = layers.rms_norm_init(cfg.d_model, dtype, dev)
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp,
                                   dtype)
    return p


def _block_forward(p: Params, cfg: ModelConfig, kind: str, x, positions,
                   mask: dict):
    """Full-sequence block. Returns (x, cache)."""
    h = layers.rms_norm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        out, cache = attention.attn_forward(p["mixer"], cfg, h, positions,
                                            mask)
    else:
        out, cache = ssm_lib.ssm_forward(p["mixer"], cfg, h)
    x = x + out
    if "mlp" in p:
        h2 = layers.rms_norm(p["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp_apply(p["mlp"], h2, cfg.mlp)
    return x, cache


def _block_decode(p: Params, cfg: ModelConfig, kind: str, x_t, pos: int,
                  cache: Params):
    h = layers.rms_norm(p["norm1"], x_t, cfg.norm_eps)
    if kind == "attn":
        out, cache = attention.attn_decode(p["mixer"], cfg, h, pos, cache)
    else:
        out, cache = ssm_lib.ssm_decode(p["mixer"], cfg, h, cache)
    x_t = x_t + out
    if "mlp" in p:
        h2 = layers.rms_norm(p["norm2"], x_t, cfg.norm_eps)
        x_t = x_t + layers.mlp_apply(p["mlp"], h2, cfg.mlp)
    return x_t, cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            dtype=torch.float32) -> Params:
    """Random params in the reference's tree, drawn on the generator's
    device."""
    check_supported(cfg)
    n_per = _n_periods(cfg)
    params: Params = {
        "embed": layers.embed_init(generator, cfg.vocab, cfg.d_model, dtype),
        "final_norm": layers.rms_norm_init(cfg.d_model, dtype,
                                           generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(generator, cfg.d_model,
                                              cfg.vocab, dtype)
    if cfg.n_dense_prefix:
        params["prefix"] = [_init_block(generator, cfg, "attn", dtype)
                            for _ in range(cfg.n_dense_prefix)]
    params["period"] = {
        f"j{j}": _stack([_init_block(generator, cfg, kind, dtype)
                         for _ in range(n_per)])
        for j, kind in enumerate(cfg.pattern)}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings [B, S, D] (the token path of the reference)."""
    return params["embed"][batch["tokens"]]


def forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
            want_cache: bool = False):
    """x: [B, S, D] embeddings -> (hidden [B, S, D], caches). ``caches``
    is ``{"prefix": [...], "period": {"j<j>": leaves [n_per, ...]}}`` when
    ``want_cache``, else None."""
    check_supported(cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    mask = {"causal": cfg.causal, "prefix_len": 0,
            "window": cfg.sliding_window}
    prefix_caches = []
    for blk in params.get("prefix", []):
        x, c = _block_forward(blk, cfg, "attn", x, positions, mask)
        prefix_caches.append(c)
    per_period = []
    for p in range(_n_periods(cfg)):
        blocks = _period(params["period"], p)
        caches = {}
        for j, kind in enumerate(cfg.pattern):
            x, c = _block_forward(blocks[f"j{j}"], cfg, kind, x, positions,
                                  mask)
            if want_cache:
                caches[f"j{j}"] = c
        per_period.append(caches)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, None
    return x, {"prefix": prefix_caches, "period": _stack(per_period)}


def _lm_head(params: Params, cfg: ModelConfig, h: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _cache_struct(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  dtype, device) -> Params:
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype, device)
    return ssm_lib.init_state(cfg, batch, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32,
                      device: DeviceLike = "cuda") -> Params:
    """Zeroed caches for decode, on ``device`` (the card unless asked
    for the CPU; raises without a GPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    n_per = _n_periods(cfg)
    state: Params = {}
    if cfg.n_dense_prefix:
        state["prefix"] = [
            _cache_struct(cfg, "attn", batch, max_len, dtype, device)
            for _ in range(cfg.n_dense_prefix)]
    state["period"] = {
        f"j{j}": _stack([_cache_struct(cfg, kind, batch, max_len, dtype,
                                       device) for _ in range(n_per)])
        for j, kind in enumerate(cfg.pattern)}
    return state


def _fill_attn_cache(cfg: ModelConfig, kv: Params, max_len: int,
                     seq_axis: int = 1) -> Params:
    """Turn a full-forward kv dict into a decode cache of capacity max_len.
    ``seq_axis`` is 1 for per-layer caches, 2 for period-stacked leaves
    ([n_per, B, S, ...])."""
    def fill(x):
        s = x.shape[seq_axis]
        if cfg.sliding_window and cfg.sliding_window < s:
            w = cfg.sliding_window
            last = x.narrow(seq_axis, s - w, w)
            return torch.roll(last, s % w, dims=seq_axis)
        if s < max_len:
            pad = [0, 0] * (x.dim() - seq_axis - 1) + [0, max_len - s]
            return torch.nn.functional.pad(x, pad)
        return x
    return _tree_map(fill, kv)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, max_len: int = 0):
    """Run the full prompt; return (last-token logits [B, V], decode
    state)."""
    x = _embed_inputs(params, cfg, batch)
    max_len = max_len or x.shape[1]
    h, caches = forward(params, cfg, x, want_cache=True)
    logits = _lm_head(params, cfg, h[:, -1, :])
    state: Params = {}
    if caches["prefix"]:
        state["prefix"] = [_fill_attn_cache(cfg, c, max_len, 1)
                           for c in caches["prefix"]]
    # recurrent states are already final; attention kv becomes a cache
    state["period"] = {
        f"j{j}": (_fill_attn_cache(cfg, caches["period"][f"j{j}"], max_len, 2)
                  if kind == "attn" else caches["period"][f"j{j}"])
        for j, kind in enumerate(cfg.pattern)}
    return logits, state


def decode_step(params: Params, cfg: ModelConfig, state: Params,
                token: torch.Tensor, pos: int):
    """token: [B] int; pos: the position being decoded (a Python int: the
    step makes no host sync). Returns (logits [B, V], state), ``state``
    updated in place."""
    check_supported(cfg)
    x_t = params["embed"][token]
    for blk, cache in zip(params.get("prefix", []), state.get("prefix", [])):
        x_t, _ = _block_decode(blk, cfg, "attn", x_t, pos, cache)
    for p in range(_n_periods(cfg)):
        blocks = _period(params["period"], p)
        caches = _period(state["period"], p)
        for j, kind in enumerate(cfg.pattern):
            x_t, _ = _block_decode(blocks[f"j{j}"], cfg, kind, x_t, pos,
                                   caches[f"j{j}"])
    x_t = layers.rms_norm(params["final_norm"], x_t, cfg.norm_eps)
    return _lm_head(params, cfg, x_t), state
