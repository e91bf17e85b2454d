"""Mamba (S6) selective-state-space block: full-sequence scan and decode
step (the JAX package's ``models/ssm.py``).

State layout for decode: ``{"conv": [B, W-1, d_in], "h": [B, d_in,
d_state]}``. The sequence recurrence of a full-sequence forward always goes
through ``kernels.ssm_scan.ops.ssm_scan``: the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor (the reference switches with
``REPRO_SSM_KERNEL``; here the tensor's device decides). Decode is one
step of the same recurrence in plain torch.

Under ``par`` (``models/parallel.py``, a step on a mesh) the block runs
on this rank's channels of d_in when its channel leaves are blocks over
the model axes (``w_out``'s rows shorter than d_in): ``w_in``'s column
block of ``[u | z]`` is gathered over the model axes and re-cut to the
rank's channels of u and of z (:func:`_in_proj`; a contiguous column
block of ``[u | z]`` is not the rank's channels of either), the conv,
``w_dt``, ``dt_bias``, ``a_log`` and ``d_skip`` are channel blocks,
``w_x``'s row block gives a partial sum of the projection (summed over
the model axes, then entering the channel blocks), the scan runs on the
rank's channels alone (the recurrence is per channel), and ``w_out``'s
row block gives a partial sum of the output. The decode state is the
rank's channels.

``jax.nn.softplus`` has no threshold; ``F.softplus`` returns x above 20,
where the two differ by log1p(exp(-20)), under 1e-8 relative.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import DeviceLike, resolve_traced
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers, parallel

Params = Dict[str, object]


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return s, d_in, dt_rank


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    s, d_in, dt_rank = _dims(cfg)
    dev = generator.device
    a_init = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                    device=dev)).expand(*lead, d_in,
                                                        s.d_state)
    return {
        "w_in": layers.dense_init(generator, cfg.d_model, 2 * d_in, dtype,
                                  lead=lead),
        "conv": layers.causal_conv_init(generator, d_in, s.d_conv, dtype,
                                        lead),
        "w_x": layers.dense_init(generator, d_in, dt_rank + 2 * s.d_state,
                                 dtype, lead=lead),
        "w_dt": layers.dense_init(generator, dt_rank, d_in, dtype,
                                  lead=lead),
        "dt_bias": torch.full((*lead, d_in), -4.6, dtype=dtype, device=dev),
        "a_log": a_init.to(dtype).contiguous(),
        "d_skip": torch.ones((*lead, d_in), dtype=dtype, device=dev),
        "w_out": layers.dense_init(generator, d_in, cfg.d_model, dtype,
                                   lead=lead),
    }


def _in_proj(params: Params, cfg: ModelConfig, x: torch.Tensor, par):
    """(u_raw, z, tp): the input projection's u and z at the channels
    this rank computes, and whether those are a block of d_in (``tp``:
    the block's output is then a partial sum over the model axes); a
    column block of ``w_in`` is gathered and re-cut
    (``parallel.column_pair``)."""
    _, d_in, _ = _dims(cfg)
    c = params["w_out"].shape[-2]                    # channels computed
    tp = par is not None and c < d_in
    u_raw, z = parallel.column_pair(par, x, params["w_in"], d_in, c, tp)
    return u_raw, z, tp


def _x_proj(params: Params, u: torch.Tensor, par, tp: bool):
    """``u @ w_x``: under ``tp`` a row block's partial sum, summed over
    the model axes and entering the channel blocks that read it."""
    proj = u @ params["w_x"]
    return par.enter_model(par.sum_model(proj)) if tp else proj


def _out_proj(params: Params, y: torch.Tensor, par, tp: bool):
    out = y @ params["w_out"]
    return par.sum_model(out) if tp else out


def _ssm_inner(params: Params, cfg: ModelConfig, u: torch.Tensor, par=None,
               tp: bool = False):
    """u: [B, T, c] (post conv+silu; c the channels computed). Returns y
    [B, T, c], final h."""
    s, d_in, dt_rank = _dims(cfg)
    proj = _x_proj(params, u, par, tp)                # [B, T, dt_rank + 2 ds]
    dt = F.softplus(proj[..., :dt_rank] @ params["w_dt"]
                    + params["dt_bias"])              # [B, T, c]
    bmat = proj[..., dt_rank:dt_rank + s.d_state]     # [B, T, ds]
    cmat = proj[..., dt_rank + s.d_state:]            # [B, T, ds]
    a = -torch.exp(params["a_log"].to(torch.float32))  # [c, ds]
    y, h = ssm_ops.ssm_scan(u, dt, bmat, cmat, a,
                            params["d_skip"].to(torch.float32))
    return y.to(u.dtype), h


def ssm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, par=None
                ) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state dict). ``par``: see the
    module docstring."""
    s, d_in, _ = _dims(cfg)
    u_raw, z, tp = _in_proj(params, cfg, x, par)
    u = F.silu(layers.causal_conv_apply(params["conv"], u_raw))
    y, h = _ssm_inner(params, cfg, u, par, tp)
    out = _out_proj(params, y * F.silu(z), par, tp)
    # the conv state holds the PRE-activation conv inputs (the last W-1 raw
    # u values, zero-padded on the left), copied out of xz so that the state
    # does not keep the [B, T, 2 d_in] projection alive
    w1 = s.d_conv - 1
    tail = u_raw[:, max(0, u_raw.shape[1] - w1):, :]
    conv_state = F.pad(tail, (0, 0, w1 - tail.shape[1], 0)).contiguous()
    return out, {"conv": conv_state, "h": h}


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device: DeviceLike = "cuda") -> Params:
    """A zeroed conv and scan state on ``device`` (the card unless asked
    for the CPU; raises without a GPU)."""
    s, d_in, _ = _dims(cfg)
    device = resolve_traced(device)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               state: Params, par=None) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new conv window and h into
    ``state`` in place and returns it. ``par``: see the module docstring
    (``state`` then holds this rank's channels)."""
    s, d_in, dt_rank = _dims(cfg)
    u_raw, z, tp = _in_proj(params, cfg, x_t, par)
    u_c, conv_state = layers.causal_conv_step(params["conv"], state["conv"],
                                              u_raw)
    u = F.silu(u_c)
    proj = _x_proj(params, u, par, tp)
    dt = F.softplus(proj[..., :dt_rank] @ params["w_dt"] + params["dt_bias"])
    b_t = proj[..., dt_rank:dt_rank + s.d_state].to(torch.float32)
    c_t = proj[..., dt_rank + s.d_state:].to(torch.float32)
    a = -torch.exp(params["a_log"].to(torch.float32))
    da = torch.exp(dt.to(torch.float32)[..., None] * a)
    h = da * state["h"] \
        + (dt * u).to(torch.float32)[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t).to(x_t.dtype) \
        + u * params["d_skip"]
    out = _out_proj(params, y * F.silu(z), par, tp)
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out, state

