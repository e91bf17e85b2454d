"""Mamba (S6) selective-state-space block: full-sequence scan and decode
step (the JAX package's ``models/ssm.py``).

State layout for decode: ``{"conv": [B, W-1, d_in], "h": [B, d_in,
d_state]}``. The sequence recurrence of a full-sequence forward always goes
through ``kernels.ssm_scan.ops.ssm_scan``: the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor (the reference switches with
``REPRO_SSM_KERNEL``; here the tensor's device decides). Decode is one
step of the same recurrence in plain torch.

``jax.nn.softplus`` has no threshold; ``F.softplus`` returns x above 20,
where the two differ by log1p(exp(-20)), under 1e-8 relative.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers

Params = Dict[str, object]


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return s, d_in, dt_rank


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    s, d_in, dt_rank = _dims(cfg)
    dev = generator.device
    a_init = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                    device=dev)).expand(d_in, s.d_state)
    return {
        "w_in": layers.dense_init(generator, cfg.d_model, 2 * d_in, dtype),
        "conv": layers.causal_conv_init(generator, d_in, s.d_conv, dtype),
        "w_x": layers.dense_init(generator, d_in, dt_rank + 2 * s.d_state,
                                 dtype),
        "w_dt": layers.dense_init(generator, dt_rank, d_in, dtype),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dtype, device=dev),
        "a_log": a_init.to(dtype).contiguous(),
        "d_skip": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": layers.dense_init(generator, d_in, cfg.d_model, dtype),
    }


def _ssm_inner(params: Params, cfg: ModelConfig, u: torch.Tensor):
    """u: [B, T, d_in] (post conv+silu). Returns y [B, T, d_in], final h."""
    s, d_in, dt_rank = _dims(cfg)
    proj = u @ params["w_x"]                          # [B, T, dt_rank + 2 ds]
    dt = F.softplus(proj[..., :dt_rank] @ params["w_dt"]
                    + params["dt_bias"])              # [B, T, d_in]
    bmat = proj[..., dt_rank:dt_rank + s.d_state]     # [B, T, ds]
    cmat = proj[..., dt_rank + s.d_state:]            # [B, T, ds]
    a = -torch.exp(params["a_log"].to(torch.float32))  # [d_in, ds]
    y, h = ssm_ops.ssm_scan(u, dt, bmat, cmat, a,
                            params["d_skip"].to(torch.float32))
    return y.to(u.dtype), h


def ssm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state dict)."""
    s, d_in, _ = _dims(cfg)
    xz = x @ params["w_in"]
    u_raw, z = xz.chunk(2, dim=-1)
    u = F.silu(layers.causal_conv_apply(params["conv"], u_raw))
    y, h = _ssm_inner(params, cfg, u)
    out = (y * F.silu(z)) @ params["w_out"]
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
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_in, s.d_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
               state: Params) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new conv window and h into
    ``state`` in place and returns it."""
    s, d_in, dt_rank = _dims(cfg)
    xz = x_t @ params["w_in"]
    u_raw, z = xz.chunk(2, dim=-1)
    u_c, conv_state = layers.causal_conv_step(params["conv"], state["conv"],
                                              u_raw)
    u = F.silu(u_c)
    proj = u @ params["w_x"]
    dt = F.softplus(proj[..., :dt_rank] @ params["w_dt"] + params["dt_bias"])
    b_t = proj[..., dt_rank:dt_rank + s.d_state].to(torch.float32)
    c_t = proj[..., dt_rank + s.d_state:].to(torch.float32)
    a = -torch.exp(params["a_log"].to(torch.float32))
    da = torch.exp(dt.to(torch.float32)[..., None] * a)
    h = da * state["h"] \
        + (dt * u).to(torch.float32)[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t).to(x_t.dtype) \
        + u * params["d_skip"]
    out = (y * F.silu(z)) @ params["w_out"]
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out, state

