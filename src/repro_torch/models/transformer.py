"""The JAX package's ``models/transformer.py``: decoder LMs (dense, MoE,
MLA), the hybrid Mamba/attention stack, xLSTM, the prefix-LM VLM and the
audio encoder, with a full forward, the training loss, prefill and a
cached decode step.

Layer layout and params are the reference's: ``n_dense_prefix`` unrolled
blocks (``params["prefix"]``), then the remaining layers grouped into
periods of ``cfg.pattern``, each pattern position ``j`` holding its blocks'
params stacked over periods (``params["period"]["j<j>"]``, leaves
``[n_per, ...]``), so weights carry across leaf for leaf
(``weights.lm_params_from_jax``). Where the reference scans over periods,
the port runs a Python loop and indexes period ``p`` of every leaf (a view);
where it wraps the period body in ``jax.checkpoint`` (``remat``), the port
wraps it in ``torch.utils.checkpoint`` (non-reentrant), which recomputes
the period in the backward pass.

Block kinds ``attn`` (GQA or MLA), ``ssm``, ``mlstm`` and ``slstm``, each
with a dense or an MoE MLP (or none, ``d_ff = 0``), as the reference's
``_init_block`` lays them out; a block takes the MoE MLP where the
reference's ``_uses_moe`` says so. Inputs as the reference's
``_embed_inputs`` takes them: tokens; for a VLM (``family == "vlm"``) the
image's patch embeddings ``[B, P, D]`` before the text tokens, under the
prefix-LM mask (``prefix_len = cfg.vlm_prefix_len``); for the audio
encoder frame embeddings ``[B, S, D]``, optionally blended with
``mask_emb`` at ``mask_positions``, plus the positional conv. The forward
returns the sum of the MoE layers' load-balance losses (``aux``), which
``train_loss`` adds to the cross-entropy.

Public API:
  init_lm(generator, cfg, dtype)                   -> params
  forward(params, cfg, x, want_cache=..., remat=...) -> (hidden, aux, caches)
  train_loss(params, cfg, batch, remat=...)        -> (loss, metrics)
  prefill(params, cfg, batch, max_len=...)         -> (logits_last, state)
  decode_step(params, cfg, state, token, pos)      -> (logits, state)
  init_decode_state(cfg, batch, max_len, ...)      -> state

``decode_step`` updates ``state`` in place (the attention caches by slice
assignment, the recurrent states by ``copy_``) and returns it.

``_embed_inputs``, ``forward``, ``prefill`` and ``decode_step`` take an
optional ``par`` (``models/parallel.py``): one rank's part of a step placed
on a mesh (``launch/steps.py``). Each block's leaves are gathered over the
FSDP axes just before it runs; a GQA or MLA block with its heads split
over the model axes runs tensor-parallel (``attention.attn_forward`` /
``attn_decode``), a Mamba block on its channels of d_in
(``ssm.ssm_forward`` / ``ssm_decode``), an MoE block on its experts
(``moe.moe_apply``), an mLSTM or sLSTM block on its heads (``xlstm``),
and so do a dense MLP with its hidden width split
(``layers.mlp_apply``), the audio front-end's positional conv on its
channels (:func:`_pos_conv`) and a vocab-split embedding: a lookup by
range, summed over the model axes, and a head whose logits stay split on
the vocab (``train_loss`` then takes a vocab-parallel cross-entropy). An
MoE block on a batch split over ranks routes with every rank's choices
(``moe.route``). Without ``par`` nothing changes.

On the card the GQA and MLA forwards launch the flash kernel and the Mamba
forward the scan kernel; under grad both go through their
``autograd.Function`` (``kernels/flash_attention/ops.py::_FlashFn``,
``kernels/ssm_scan/ops.py::_ScanFn``), whose backward launches the
hand-written backward kernel, so every arch trains on the card (fp32); on
the CPU the plain versions run, which autograd follows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_traced
from repro_torch.models import attention, layers, moe as moe_lib, \
    ssm as ssm_lib, xlstm as xlstm_lib
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_MIXER_INIT = {"attn": attention.init_attention, "ssm": ssm_lib.init_ssm,
               "mlstm": xlstm_lib.init_mlstm, "slstm": xlstm_lib.init_slstm}
# the recurrent mixers' full-sequence forward, decode step and zeroed state
_FORWARD = {"ssm": ssm_lib.ssm_forward, "mlstm": xlstm_lib.mlstm_forward,
            "slstm": xlstm_lib.slstm_forward}
_DECODE = {"ssm": ssm_lib.ssm_decode, "mlstm": xlstm_lib.mlstm_decode,
           "slstm": xlstm_lib.slstm_decode}
_STATE = {"ssm": ssm_lib.init_state, "mlstm": xlstm_lib.init_mlstm_state,
          "slstm": xlstm_lib.init_slstm_state}
# the profiler range around each recurrent mixer's forward, named by kind
# ("mixer:slstm"), so a profile splits a prefill's host time by block kind
MIXER_RANGE = "mixer:"


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


def _uses_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    if cfg.moe is None or layer_idx < cfg.n_dense_prefix:
        return False
    return layer_idx % cfg.moe.every == cfg.moe.every - 1


def _check_static_period(cfg: ModelConfig) -> None:
    """MoE placement must be the same in every period so params can
    stack."""
    if cfg.moe is not None and cfg.moe.every > 1 \
            and len(cfg.pattern) % cfg.moe.every and len(cfg.pattern) != 1:
        raise ValueError(f"{cfg.name}: moe.every={cfg.moe.every} "
                         f"incompatible with pattern length "
                         f"{len(cfg.pattern)}")


def _period(tree: Params, p: int) -> Params:
    """Period p of a period-stacked tree (views)."""
    return tree_map(lambda x: x[p], tree)


def _stack(trees: List[Params]) -> Params:
    """Stack trees (caches) leaf by leaf on a new leading period axis; one
    period becomes a view, with no copy."""
    if len(trees) == 1:
        return tree_map(lambda x: x.unsqueeze(0), trees[0])
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
                use_moe: bool, dtype, lead: Tuple[int, ...] = ()) -> Params:
    dev = generator.device
    p: Params = {"norm1": layers.rms_norm_init(cfg.d_model, dtype, dev, lead),
                 "mixer": _MIXER_INIT[kind](generator, cfg, dtype, lead)}
    if use_moe or cfg.d_ff > 0:
        p["norm2"] = layers.rms_norm_init(cfg.d_model, dtype, dev, lead)
    if use_moe:
        p["moe"] = moe_lib.init_moe(generator, cfg, dtype, lead)
    elif cfg.d_ff > 0:
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp,
                                   dtype, lead)
    return p


def _mlp_half(p: Params, cfg: ModelConfig, x, moe_drops=None, par=None):
    """(x + the block's MLP (dense or MoE) of norm2(x), the MoE's
    load-balance loss or None), x: [..., D]; every token of x is one of the
    MoE's T (the reference's [B, S, D] and, in decode, [B, 1, D])."""
    h2 = layers.rms_norm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        out, aux = moe_lib.moe_apply(
            p["moe"], cfg, h2.reshape(-1, 1, cfg.d_model), moe_drops, par)
        return x + out.reshape(x.shape), aux
    split = par is not None and p["mlp"]["w_out"].shape[0] < cfg.d_ff
    return x + layers.mlp_apply(p["mlp"], h2, cfg.mlp,
                                par if split else None), None


def _block_forward(p: Params, cfg: ModelConfig, kind: str, x, positions,
                   mask: dict, moe_drops=None, par=None):
    """Full-sequence block. Returns (x, aux or None, cache)."""
    h = layers.rms_norm(p["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        out, cache = attention.attn_forward(p["mixer"], cfg, h, positions,
                                            mask, par)
    else:
        with torch.profiler.record_function(MIXER_RANGE + kind):
            out, cache = _FORWARD[kind](p["mixer"], cfg, h, par=par)
    x = x + out
    aux = None
    if "norm2" in p:
        x, aux = _mlp_half(p, cfg, x, moe_drops, par)
    return x, aux, cache


def _block_decode(p: Params, cfg: ModelConfig, kind: str, x_t, pos: int,
                  cache: Params, par=None):
    h = layers.rms_norm(p["norm1"], x_t, cfg.norm_eps)
    if kind == "attn":
        out, cache = attention.attn_decode(p["mixer"], cfg, h, pos, cache,
                                           par)
    else:
        out, cache = _DECODE[kind](p["mixer"], cfg, h, cache, par=par)
    x_t = x_t + out
    if "norm2" in p:
        x_t, _ = _mlp_half(p, cfg, x_t, par=par)
    return x_t, cache


def _unshard(par, tree: Params, path: str, stacked: bool = False) -> Params:
    """``tree`` with its FSDP blocks gathered under ``par`` (as it is
    without)."""
    return tree if par is None else par.unshard(tree, path, stacked)


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            dtype=torch.float32) -> Params:
    """Random params in the reference's tree, drawn on the generator's
    device."""
    _check_static_period(cfg)
    n_per = _n_periods(cfg)
    params: Params = {
        "embed": layers.embed_init(generator, cfg.vocab, cfg.d_model, dtype),
        "final_norm": layers.rms_norm_init(cfg.d_model, dtype,
                                           generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(generator, cfg.d_model,
                                              cfg.vocab, dtype)
    if cfg.audio_frontend:
        params["mask_emb"] = layers._randn(generator, (cfg.d_model,), 0.02,
                                           dtype)
        params["pos_conv"] = layers.causal_conv_init(generator, cfg.d_model,
                                                     4, dtype)
    if cfg.n_dense_prefix:
        params["prefix"] = [_init_block(generator, cfg, "attn", False, dtype)
                            for _ in range(cfg.n_dense_prefix)]
    # each pattern position's blocks drawn at [n_per, ...] in place
    params["period"] = {
        f"j{j}": _init_block(generator, cfg, kind,
                             _uses_moe(cfg, cfg.n_dense_prefix + j), dtype,
                             (n_per,))
        for j, kind in enumerate(cfg.pattern)}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _lookup(emb: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            par=None) -> torch.Tensor:
    """The embeddings of ``tokens``. Under ``par`` a vocab block of the
    table (shorter than the vocab) looks up the tokens in its range, zeros
    elsewhere, summed over the model axes."""
    if par is None or emb.shape[0] == cfg.vocab:
        return emb[tokens]
    rows = emb.shape[0]
    local = tokens - par.model_index * rows
    inside = (local >= 0) & (local < rows)
    out = emb[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return par.sum_model(out)


def _pos_conv(p: Params, frames: torch.Tensor, cfg: ModelConfig, par=None
              ) -> torch.Tensor:
    """The audio front-end's positional conv of ``frames`` [B, S, D].
    Under ``par`` a channel block of ``pos_conv`` (shorter than D) runs on
    the rank's channels of the whole frames, which enter the block (under
    autograd the gradient of the frames blended with ``mask_emb``, each
    rank's on its channels, is summed), and the result is gathered over
    the model axes for every rank to read whole (``gather_whole``: its
    gradient cut to the block)."""
    c = p["w"].shape[-1]
    if par is None or c == cfg.d_model:
        return layers.causal_conv_apply(p, frames)
    lo = par.model_index * c
    own = par.enter_model(frames)[..., lo:lo + c]
    return par.gather_whole(layers.causal_conv_apply(p, own), -1)


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], par=None):
    """(the model's input [B, S, D], labels or None, loss mask or None), as
    the reference's ``_embed_inputs`` builds them: for a VLM ``patches``
    [B, P, D] then the embeddings of ``tokens`` [B, S - P] (P may be all of
    S: ``tokens`` [B, 0]), with ``labels`` [B, S - P], when given, padded
    by 0 over the P patches and the mask 0 there and 1 on the text; for the
    audio encoder ``frames`` [B, S, D], with ``mask_emb`` in place of the
    frames at ``mask_positions`` [B, S] (0/1) when given, plus the
    positional conv of the result, the labels ``targets`` and the mask
    ``mask_positions`` as float; else the embeddings of ``tokens``, with
    ``labels`` and ``loss_mask`` as given. ``par``: see :func:`_lookup`
    (the VLM's patches arrive whole on every model rank beside the
    lookup of its text) and :func:`_pos_conv`."""
    emb = _unshard(par, params["embed"], "embed")
    if cfg.family == "vlm":
        patches = batch["patches"].to(emb.dtype)
        x = torch.cat([patches, _lookup(emb, batch["tokens"], cfg, par)],
                      dim=1)
        labels = batch.get("labels")
        if labels is None:
            return x, None, None
        b, p = patches.shape[:2]
        labels = torch.cat([labels.new_zeros((b, p)), labels], dim=1)
        mask = torch.cat([
            torch.zeros((b, p), dtype=torch.float32, device=x.device),
            torch.ones(batch["labels"].shape, dtype=torch.float32,
                       device=x.device)], dim=1)
        return x, labels, mask
    if cfg.audio_frontend:
        frames = batch["frames"].to(emb.dtype)
        mask = batch.get("mask_positions")
        if mask is not None:
            m = mask[..., None].to(emb.dtype)
            frames = frames * (1 - m) + params["mask_emb"] * m
            mask = mask.to(torch.float32)
        x = frames + _pos_conv(params["pos_conv"], frames, cfg, par)
        return x, batch.get("targets"), mask
    return (_lookup(emb, batch["tokens"], cfg, par), batch.get("labels"),
            batch.get("loss_mask"))


def forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
            want_cache: bool = False, remat: bool = True,
            moe_drops: Optional[List[Tuple[int, torch.Tensor]]] = None,
            par=None):
    """x: [B, S, D] embeddings -> (hidden [B, S, D], aux, caches). ``aux``
    is the sum of the MoE layers' load-balance losses (a 0-dim fp32
    tensor, 0 without MoE). ``caches`` is ``{"prefix": [...], "period":
    {"j<j>": leaves [n_per, ...]}}`` when ``want_cache``, else None.
    ``remat`` recomputes each period in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its period body) when the forward is differentiated (grad mode on, x
    requiring grad); it changes no value. With
    ``moe_drops`` given, each MoE layer appends its (assignments, dropped
    count) to it (``moe.moe_apply``). ``par``: one rank's part of a step
    on a mesh (``models/parallel.py``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    mask = {"causal": cfg.causal,
            "prefix_len": cfg.vlm_prefix_len if cfg.family == "vlm" else 0,
            "window": cfg.sliding_window}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_caches = []
    for i, blk in enumerate(params.get("prefix", [])):
        x, aux, c = _block_forward(_unshard(par, blk, f"prefix/{i}"), cfg,
                                   "attn", x, positions, mask, moe_drops,
                                   par)
        if aux is not None:
            aux_total = aux_total + aux
        prefix_caches.append(c)

    def period_body(x, aux_acc, blocks):
        caches = {}
        for j, kind in enumerate(cfg.pattern):
            blk = _unshard(par, blocks[f"j{j}"], f"period/j{j}", True)
            x, aux, c = _block_forward(blk, cfg, kind, x, positions, mask,
                                       moe_drops, par)
            if aux is not None:
                aux_acc = aux_acc + aux
            if want_cache:
                caches[f"j{j}"] = c
        return x, aux_acc, caches

    per_period = []
    for p in range(_n_periods(cfg)):
        blocks = _period(params["period"], p)
        if remat and torch.is_grad_enabled() and x.requires_grad:
            x, aux_total, caches = checkpoint(
                period_body, x, aux_total, blocks, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux_total, caches = period_body(x, aux_total, blocks)
        per_period.append(caches)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, aux_total, None
    return x, aux_total, {"prefix": prefix_caches,
                          "period": _stack(per_period)}


def _head_weight(params: Params, cfg: ModelConfig, par=None
                 ) -> torch.Tensor:
    """The head's [D, V] weight (the tied embedding transposed), its FSDP
    blocks gathered under ``par``."""
    if cfg.tie_embeddings:
        return _unshard(par, params["embed"], "embed").T
    return _unshard(par, params["lm_head"], "lm_head")


def _lm_head(params: Params, cfg: ModelConfig, h: torch.Tensor, par=None,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits of ``h``; under ``par`` of the vocab block this rank holds
    (every vocab entry when the head is whole), ``h`` entering the vocab
    block as a column block's input (``par.enter_model``). ``w``: the
    head's weight when the caller gathered it (:func:`_head_weight`)."""
    if w is None:
        w = _head_weight(params, cfg, par)
    if par is not None and w.shape[-1] < cfg.vocab:
        h = par.enter_model(h)
    return h @ w


def ce_chunk(batch: int, seq: int, vocab: int, chunk: int = 0) -> int:
    """The sequence chunk :func:`chunked_ce_loss` takes: ``chunk`` when
    given (it must divide ``seq``), else the reference's rule, about 256 MB
    of fp32 logits a chunk (256e6 / (B V 4) positions, at most S), stepped
    down until it divides S."""
    if chunk <= 0:
        chunk = max(1, min(seq, int(256e6 / max(batch * vocab * 4, 1))))
        while seq % chunk:
            chunk -= 1
    elif seq % chunk:
        raise ValueError(f"a loss chunk of {chunk} does not divide the "
                         f"sequence of {seq}")
    return chunk


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor,
                          par) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, the label's logit) over the whole vocab from this
    rank's vocab block of the fp32 ``logits`` [..., V / m]: the max is the
    largest of the model ranks' maxima (gathered, without grad), the sum
    of the exponentials and the label's logit (this rank's where its block
    holds the label, else 0) are summed over the model ranks
    (``par.sum_model``)."""
    rows = logits.shape[-1]
    with torch.no_grad():
        top = par.gather_model(logits.amax(-1, keepdim=True), -1) \
            .amax(-1, keepdim=True)
    sumexp = par.sum_model(torch.exp(logits - top).sum(-1))
    local = labels - par.model_index * rows
    inside = (local >= 0) & (local < rows)
    gold = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    gold = par.sum_model(gold.masked_fill(~inside, 0.0))
    return top[..., 0] + torch.log(sumexp), gold


def chunked_ce_loss(params: Params, cfg: ModelConfig, h: torch.Tensor,
                    labels: torch.Tensor, loss_mask: Optional[torch.Tensor],
                    chunk: int = 0, par=None) -> torch.Tensor:
    """Mean cross-entropy of the LM head on h [B, S, D] against labels
    [B, S] under loss_mask [B, S] (all ones when None), without the whole
    [B, S, V] logits: the sequence runs in chunks (:func:`ce_chunk`, at
    the whole vocab also under ``par``), one at a time, in a Python loop
    (the reference's ``lax.scan``). The mean is over the mask's sum (at
    least 1); no host sync. Under ``par`` with a vocab-split head each
    rank computes its vocab block's logits and the loss is vocab-parallel
    (:func:`_vocab_parallel_terms`): the same loss on every model rank.
    The head is gathered over the FSDP axes once, for every chunk. Under
    ``par.batch_loss`` (h: this rank's rows of the client's) the sum and
    the count are summed over the batch ranks (``par.sum_batch``), so the
    mean is over all the client's rows, the same on every rank."""
    b, s, _ = h.shape
    chunk = ce_chunk(b, s, cfg.vocab, chunk)
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    w = _head_weight(params, cfg, par)
    for c0 in range(0, s, chunk):
        logits = _lm_head(params, cfg, h[:, c0:c0 + chunk], par,
                          w).to(torch.float32)
        lab = labels[:, c0:c0 + chunk]
        if logits.shape[-1] < cfg.vocab:
            logz, gold = _vocab_parallel_terms(logits, lab, par)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lab[..., None])[..., 0]
        mc = loss_mask[:, c0:c0 + chunk].to(torch.float32)
        tot = tot + ((logz - gold) * mc).sum()
        cnt = cnt + mc.sum()
    if par is not None and par.batch_loss:
        both = par.sum_batch(torch.stack([tot, cnt]))
        tot, cnt = both[0], both[1]
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], *, remat: bool = True,
               loss_chunk: int = 0, par=None):
    """The reference's loss by family: causal LM (``tokens`` [B, S]: the
    first S - 1 positions predict the next token, under ``loss_mask``'s
    last S - 1 columns when given); prefix LM for a VLM (``patches`` and
    ``tokens``: the text's next-token loss, the patches unscored); masked
    prediction for the audio encoder (``targets`` at ``mask_positions``).
    Returns (ce + aux, {"ce": ce, "aux": aux}), 0-dim tensors. ``par``:
    one rank's part of the train step on a mesh (``models/parallel.py``:
    the model-split forward and the vocab-parallel loss, the same on
    every model rank; under ``par.batch_loss`` the mean over every batch
    rank's rows, each leaf that no FSDP axis splits entering the batch,
    ``par.enter_params``)."""
    if par is not None:
        params = par.enter_params(params)
    if cfg.family == "vlm":
        tokens = batch["tokens"]
        x, labels, mask = _embed_inputs(params, cfg, {
            "patches": batch["patches"], "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:]}, par)
    elif cfg.audio_frontend:
        x, labels, mask = _embed_inputs(params, cfg, batch, par)
    else:
        tokens = batch["tokens"]
        x, _, _ = _embed_inputs(params, cfg, {"tokens": tokens[:, :-1]},
                                par)
        labels = tokens[:, 1:]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:]
    h, aux, _ = forward(params, cfg, x, remat=remat, par=par)
    ce = chunked_ce_loss(params, cfg, h, labels, mask, loss_chunk, par)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _cache_struct(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  dtype, device) -> Params:
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype, device)
    return _STATE[kind](cfg, batch, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32,
                      device: DeviceLike = "cuda") -> Params:
    """Zeroed caches for decode, on ``device`` (the card unless asked
    for the CPU; raises without a GPU)."""
    device = resolve_traced(device)
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
    return tree_map(fill, kv)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, max_len: int = 0,
            moe_drops: Optional[List[Tuple[int, torch.Tensor]]] = None,
            par=None):
    """Run the full prompt (a batch as :func:`_embed_inputs` takes it);
    return (last-token logits [B, V], decode state). ``moe_drops`` and
    ``par`` as in :func:`forward`; under ``par`` the logits are this
    rank's vocab block and the kv caches hold the kv heads its attention
    computed (``launch/steps.py`` moves them to the decode layout)."""
    x, _, _ = _embed_inputs(params, cfg, batch, par)
    max_len = max_len or x.shape[1]
    h, _, caches = forward(params, cfg, x, want_cache=True, remat=False,
                           moe_drops=moe_drops, par=par)
    logits = _lm_head(params, cfg, h[:, -1, :], par)
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
                token: torch.Tensor, pos: int, par=None):
    """token: [B] int; pos: the position being decoded (a Python int: the
    step makes no host sync). Returns (logits [B, V], state), ``state``
    updated in place. ``par`` as in :func:`forward` (the logits are then
    this rank's vocab block)."""
    x_t = _lookup(_unshard(par, params["embed"], "embed"), token, cfg, par)
    for i, (blk, cache) in enumerate(zip(params.get("prefix", []),
                                         state.get("prefix", []))):
        x_t, _ = _block_decode(_unshard(par, blk, f"prefix/{i}"), cfg,
                               "attn", x_t, pos, cache, par)
    for p in range(_n_periods(cfg)):
        blocks = _period(params["period"], p)
        caches = _period(state["period"], p)
        for j, kind in enumerate(cfg.pattern):
            blk = _unshard(par, blocks[f"j{j}"], f"period/j{j}", True)
            x_t, _ = _block_decode(blk, cfg, kind, x_t, pos,
                                   caches[f"j{j}"], par)
    x_t = layers.rms_norm(params["final_norm"], x_t, cfg.norm_eps)
    return _lm_head(params, cfg, x_t, par), state
