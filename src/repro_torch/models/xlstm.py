"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory) with stabilized exponential gating, each with a full-sequence
forward and a decode step (the JAX package's ``models/xlstm.py``).

States (fp32):
  mLSTM: ``{"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H],
           "conv": [B, W-1, d_in]}``
  sLSTM: ``{"c", "n", "m", "h": [B, H, hd], "conv": [B, W-1, d_in]}``

The reference computes both forms outside Pallas (``lax.scan``), and so
does the port, in plain torch: no kernel runs here. The mLSTM forward takes
the chunkwise-parallel form (the state crosses device memory once a chunk;
inside a chunk a masked attention-like batched product) when the chunk rule
gives one, else the sequential recurrence. The chunk rule is the
reference's: the largest divisor of T that is at most ``MLSTM_CHUNK``,
none below 16, chunkwise only when T > chunk (T = 128 runs sequential,
2048 runs 16 chunks of 128, 4095 chunks of 117). Where the reference reads
``REPRO_MLSTM_CHUNK`` from the environment at import, the port takes a
``chunk=`` keyword (0 forces the sequential form).

The sLSTM forward computes the four input projections of the whole sequence
before its time loop (four GEMMs over [B T, d_in], stacked as the reference
stacks them a step), so each of the T steps runs only the recurrent product
(one batched GEMM against the heads' [hd, 4 hd] recurrent weights, laid out
once a forward) and the gates. The same math, summed in another order, held
to the reference's tolerance by the tests. The reference keeps the
projections inside its scan because hoisting them cost a TPU training step
more memory traffic (its note at ``slstm_forward``); this path serves and
takes no gradient, so that reason does not bind here.

Decode writes the states in place (``copy_``), as ``ssm_decode`` does, and
returns them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers

Params = Dict[str, object]

# the chunkwise form's largest chunk (the reference's REPRO_MLSTM_CHUNK
# default); a chunk must divide the sequence
MLSTM_CHUNK = 128
_NEG_M = -1e30   # the stabilizer's start


def _dims(cfg: ModelConfig):
    x = cfg.xlstm or XLSTMConfig()
    d_in = int(x.proj_factor * cfg.d_model)
    return x, d_in, d_in // cfg.n_heads


def _conv_state(u_raw: torch.Tensor, width: int) -> torch.Tensor:
    """The last W-1 PRE-conv inputs, zero-padded on the left, copied so
    that the state does not keep the up-projection alive."""
    w1 = width - 1
    tail = u_raw[:, max(0, u_raw.shape[1] - w1):, :]
    return F.pad(tail, (0, 0, w1 - tail.shape[1], 0)).contiguous()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    x, d_in, _ = _dims(cfg)
    dev = generator.device

    def dense(din, dout):
        return layers.dense_init(generator, din, dout, dtype, lead=lead)

    return {
        "w_up": dense(cfg.d_model, 2 * d_in),
        "conv": layers.causal_conv_init(generator, d_in, x.conv_width, dtype,
                                        lead),
        "w_q": dense(d_in, d_in),
        "w_k": dense(d_in, d_in),
        "w_v": dense(d_in, d_in),
        "w_i": dense(d_in, cfg.n_heads),
        "w_f": dense(d_in, cfg.n_heads),
        "f_bias": torch.full((*lead, cfg.n_heads), 3.0, dtype=dtype,
                             device=dev),   # forget gate open at init
        "o_norm": layers.rms_norm_init(d_in, dtype, dev, lead),
        "w_down": dense(d_in, cfg.d_model),
    }


def _mlstm_gates_qkv(params: Params, cfg: ModelConfig, u: torch.Tensor):
    """u: [B, T, d_in] after conv and silu -> q, k, v [B, T, H, hd] and the
    input / forget pre-activations [B, T, H] in fp32."""
    _, _, hd = _dims(cfg)
    b, t, _ = u.shape
    q = (u @ params["w_q"]).reshape(b, t, cfg.n_heads, hd)
    k = (u @ params["w_k"]).reshape(b, t, cfg.n_heads, hd) * hd ** -0.5
    v = (u @ params["w_v"]).reshape(b, t, cfg.n_heads, hd)
    i_pre = (u @ params["w_i"]).to(torch.float32)
    f_pre = (u @ params["w_f"]).to(torch.float32) \
        + params["f_bias"].to(torch.float32)
    return q, k, v, i_pre, f_pre


def _mlstm_step(carry, inp):
    """One step of the stabilized mLSTM recurrence. carry: C [B, H, hd,
    hd], n [B, H, hd], m [B, H]; inp: q, k, v [B, H, hd], i, f [B, H]."""
    C, n, m = carry
    q_t, k_t, v_t, i_pre, f_pre = inp
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(i_pre - m_new)
    C = f_s[..., None, None] * C \
        + i_s[..., None, None] * (v_t[..., :, None] * k_t[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * k_t
    num = torch.einsum("bhvk,bhk->bhv", C, q_t)
    den = torch.einsum("bhk,bhk->bh", n, q_t).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C, n, m_new), h


def _mlstm_sequential(q, k, v, i_pre, f_pre, carry):
    """The recurrence step by step over T; returns (carry, h [B, T, H,
    hd])."""
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    hs = []
    for t in range(q.shape[1]):
        carry, h = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], f_pre[:, t]))
        hs.append(h)
    return carry, torch.stack(hs, dim=1)


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, carry, chunk: int):
    """The chunkwise-parallel mLSTM, the reference's derivation: with b_t =
    cumsum(log f) and M_t = max(m_in, cummax_{s<=t}(i_s - b_s)) in a chunk,
      m_t = b_t + M_t,
      h_t = [sum_{s<=t} exp(b_t - b_s + i_s - m_t) (q_t.k_s) v_s
             + exp(b_t + m_in - m_t) q_t.C_in] / den_t,
      den_t = max(|the same weights on (q_t.k_s), q_t.n_in|, exp(-m_t)),
    and the carry update is row t = L applied to (C, n). The chunks run in
    order (each needs the last one's carry); inside one, every product is
    batched. The intra-chunk mask is applied after the exponential, with
    ``where``: the masked entries of exp(D) may be inf."""
    t = q.shape[1]
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()[None, :, :, None]
    C_in, n_in, m_in = carry
    outs = []
    for c0 in range(0, t, chunk):
        qc, kc, vc = (x[:, c0:c0 + chunk] for x in (q, k, v))
        ic, fc = i_pre[:, c0:c0 + chunk], f_pre[:, c0:c0 + chunk]  # [B, L, H]
        bcum = torch.cumsum(F.logsigmoid(fc), dim=1)            # inclusive
        M = torch.maximum(m_in[:, None],
                          torch.cummax(ic - bcum, dim=1).values)
        m = bcum + M                                            # [B, L, H]
        dmat = (bcum[:, :, None] - bcum[:, None, :] + ic[:, None, :]
                - m[:, :, None])                                # [B, t, s, H]
        w = torch.where(mask, torch.exp(dmat), 0.0)
        sw = torch.einsum("bthd,bshd->btsh", qc, kc) * w
        intra = torch.einsum("btsh,bshd->bthd", sw, vc)
        inter_scale = torch.exp(bcum + m_in[:, None] - m)       # [B, L, H]
        # C is [B, H, v, k] (v_t k_t^T): q contracts with the k axis
        inter = torch.einsum("bthk,bhvk->bthv", qc, C_in) \
            * inter_scale[..., None]
        den_dot = sw.sum(dim=2) \
            + torch.einsum("bthd,bhd->bth", qc, n_in) * inter_scale
        den = torch.maximum(den_dot.abs(), torch.exp(-m))
        outs.append((intra + inter) / den[..., None])
        b_tot, m_out = bcum[:, -1], m[:, -1]                    # [B, H]
        carry_w = torch.exp(b_tot[:, None] - bcum + ic - m_out[:, None])
        decay = torch.exp(b_tot + m_in - m_out)
        C_in = decay[..., None, None] * C_in + torch.einsum(
            "blhd,blhe->bhde", carry_w[..., None] * vc, kc)
        n_in = decay[..., None] * n_in \
            + torch.einsum("blh,blhd->bhd", carry_w, kc)
        m_in = m_out
    return (C_in, n_in, m_in), torch.cat(outs, dim=1)


def mlstm_chunk(t: int, chunk: Optional[int] = None) -> int:
    """The chunk the forward takes at sequence length t (0: sequential).
    ``chunk=None`` is the reference's rule: the largest divisor of t that
    is at most MLSTM_CHUNK, none below 16; a chunk that does not divide t,
    or is not below it, also runs sequential."""
    if chunk is None:
        chunk = max(c for c in range(1, min(MLSTM_CHUNK, t) + 1)
                    if t % c == 0)
        if chunk < 16:
            chunk = 0
    return chunk if chunk and t % chunk == 0 and t > chunk else 0


def mlstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  chunk: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state). ``chunk`` as in
    :func:`mlstm_chunk`."""
    xcfg, d_in, hd = _dims(cfg)
    b, t, _ = x.shape
    u_raw, z = (x @ params["w_up"]).chunk(2, dim=-1)
    u = F.silu(layers.causal_conv_apply(params["conv"], u_raw))
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(params, cfg, u)
    carry = (torch.zeros((b, cfg.n_heads, hd, hd), device=x.device),
             torch.zeros((b, cfg.n_heads, hd), device=x.device),
             torch.full((b, cfg.n_heads), _NEG_M, device=x.device))
    chunk = mlstm_chunk(t, chunk)
    if chunk:
        carry, hs = _mlstm_chunkwise(q, k, v, i_pre, f_pre, carry, chunk)
    else:
        carry, hs = _mlstm_sequential(q, k, v, i_pre, f_pre, carry)
    h = layers.rms_norm(params["o_norm"], hs.reshape(b, t, d_in).to(x.dtype),
                        cfg.norm_eps)
    out = (h * F.silu(z)) @ params["w_down"]
    return out, {"C": carry[0], "n": carry[1], "m": carry[2],
                 "conv": _conv_state(u_raw, xcfg.conv_width)}


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = "cuda") -> Params:
    """A zeroed mLSTM state on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    x, d_in, hd = _dims(cfg)
    device = resolve_device(device)
    h = cfg.n_heads
    return {"C": torch.zeros((batch, h, hd, hd), device=device),
            "n": torch.zeros((batch, h, hd), device=device),
            "m": torch.full((batch, h), _NEG_M, device=device),
            "conv": torch.zeros((batch, x.conv_width - 1, d_in), dtype=dtype,
                                device=device)}


def mlstm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                 state: Params) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new state into ``state`` in place
    and returns it."""
    _, d_in, _ = _dims(cfg)
    u_raw, z = (x_t @ params["w_up"]).chunk(2, dim=-1)
    u_c, conv_state = layers.causal_conv_step(params["conv"], state["conv"],
                                              u_raw)
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(params, cfg,
                                             F.silu(u_c)[:, None, :])
    (C, n, m), h = _mlstm_step(
        (state["C"], state["n"], state["m"]),
        (q[:, 0].to(torch.float32), k[:, 0].to(torch.float32),
         v[:, 0].to(torch.float32), i_pre[:, 0], f_pre[:, 0]))
    h = layers.rms_norm(params["o_norm"],
                        h.reshape(x_t.shape[0], d_in).to(x_t.dtype),
                        cfg.norm_eps)
    out = (h * F.silu(z)) @ params["w_down"]
    for key, new in (("C", C), ("n", n), ("m", m), ("conv", conv_state)):
        state[key].copy_(new)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    x, d_in, hd = _dims(cfg)
    dev = generator.device

    def dense(din, dout):
        return layers.dense_init(generator, din, dout, dtype, lead=lead)

    def rec():   # a head's recurrent weights (block diagonal): [H, hd, hd]
        return layers._randn(generator, (*lead, cfg.n_heads, hd, hd),
                             hd ** -0.5, dtype)

    p = {"w_up": dense(cfg.d_model, d_in),
         "conv": layers.causal_conv_init(generator, d_in, x.conv_width,
                                         dtype, lead)}
    for g in "zifo":
        p[f"w_{g}"] = dense(d_in, d_in)
    for g in "zifo":
        p[f"r_{g}"] = rec()
    p.update({"f_bias": torch.full((*lead, d_in), 3.0, dtype=dtype,
                                   device=dev),
              "o_norm": layers.rms_norm_init(d_in, dtype, dev, lead),
              "w_down": dense(d_in, cfg.d_model)})
    return p


def _slstm_proj(params: Params, u: torch.Tensor) -> torch.Tensor:
    """The input projections of u [..., d_in], stacked as [..., 4, d_in]
    in the order z, i, f, o."""
    return torch.stack([u @ params[f"w_{g}"] for g in "zifo"], dim=-2)


def _slstm_recurrent(params: Params) -> torch.Tensor:
    """The four recurrent weights [H, hd, hd] laid out once as [H, hd, 4
    hd] (gates z, i, f, o along the last axis), so a step's recurrent
    product is one batched GEMM over the heads."""
    r = torch.stack([params[f"r_{g}"] for g in "zifo"], dim=2)
    h, hd = r.shape[0], r.shape[1]
    return r.reshape(h, hd, 4 * hd)


def _slstm_step_rec(r_cat: torch.Tensor, f_bias: torch.Tensor, carry,
                    proj_t: torch.Tensor):
    """One step from the input projections proj_t [B, 4, d_in] (z, i, f,
    o); carry (c, n, m, h), each [B, H, hd] fp32; r_cat from
    ``_slstm_recurrent``; f_bias [1, H, hd] fp32."""
    c, n, m, h = carry
    b = proj_t.shape[0]
    nh, hd = h.shape[1], h.shape[2]
    rec = torch.bmm(h.to(r_cat.dtype).transpose(0, 1), r_cat)  # [H, B, 4 hd]
    gates = proj_t.reshape(b, 4, nh, hd).to(torch.float32) \
        + rec.view(nh, b, 4, hd).permute(1, 2, 0, 3).to(torch.float32)
    z = torch.tanh(gates[:, 0])
    i_pre = gates[:, 1]
    f_pre = gates[:, 2] + f_bias
    o = torch.sigmoid(gates[:, 3])
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(i_pre - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def _f_bias(params: Params, cfg: ModelConfig) -> torch.Tensor:
    _, _, hd = _dims(cfg)
    return params["f_bias"].to(torch.float32).reshape(1, cfg.n_heads, hd)


def slstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state): the input projections
    of all T steps first, then the recurrence step by step."""
    xcfg, d_in, hd = _dims(cfg)
    b, t, _ = x.shape
    u_raw = x @ params["w_up"]
    proj = _slstm_proj(params, F.silu(layers.causal_conv_apply(
        params["conv"], u_raw)))                       # [B, T, 4, d_in]
    shape = (b, cfg.n_heads, hd)
    carry = (torch.zeros(shape, device=x.device),
             torch.zeros(shape, device=x.device),
             torch.full(shape, _NEG_M, device=x.device),
             torch.zeros(shape, device=x.device))
    r_cat, f_bias = _slstm_recurrent(params), _f_bias(params, cfg)
    hs = []
    for step in range(t):
        carry, h = _slstm_step_rec(r_cat, f_bias, carry, proj[:, step])
        hs.append(h)
    del proj
    h = layers.rms_norm(params["o_norm"],
                        torch.stack(hs, dim=1).reshape(b, t, d_in)
                        .to(x.dtype), cfg.norm_eps)
    return h @ params["w_down"], {
        "c": carry[0], "n": carry[1], "m": carry[2], "h": carry[3],
        "conv": _conv_state(u_raw, xcfg.conv_width)}


def init_slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = "cuda") -> Params:
    """A zeroed sLSTM state on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    x, d_in, hd = _dims(cfg)
    device = resolve_device(device)
    shape = (batch, cfg.n_heads, hd)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, _NEG_M, device=device),
            "h": torch.zeros(shape, device=device),
            "conv": torch.zeros((batch, x.conv_width - 1, d_in), dtype=dtype,
                                device=device)}


def slstm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                 state: Params) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new state into ``state`` in place
    and returns it."""
    _, d_in, _ = _dims(cfg)
    u_c, conv_state = layers.causal_conv_step(params["conv"], state["conv"],
                                              x_t @ params["w_up"])
    carry = (state["c"], state["n"], state["m"], state["h"])
    carry, h = _slstm_step_rec(_slstm_recurrent(params), _f_bias(params, cfg),
                               carry, _slstm_proj(params, F.silu(u_c)))
    h = layers.rms_norm(params["o_norm"],
                        h.reshape(x_t.shape[0], d_in).to(x_t.dtype),
                        cfg.norm_eps)
    for key, new in zip(("c", "n", "m", "h", "conv"), (*carry, conv_state)):
        state[key].copy_(new)
    return h @ params["w_down"], state
