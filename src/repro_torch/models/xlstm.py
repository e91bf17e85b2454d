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

On meta tensors (the dry-run, ``launch/dryrun.py``) the sLSTM's T steps,
identical in shape, run as one step that the cost counters count T times
(``launch.cost_analysis.repeated``; under grad :class:`_SLSTMSteps`, its
backward likewise, with the engine's sum of each step's slice of the
projections' gradient), as the reference's HLO count multiplies its
scan's body by its trips: a trace of T = 32 768 steps op by op would take
hours on meta tensors.

Under ``par`` (``models/parallel.py``, a step on a mesh) a block runs on
this rank's channels of d_in when its channel leaves are blocks over the
model axes (``w_down``'s rows shorter than d_in); d_in = H hd, so a block
of channels is a block of heads when H divides by the model extent. The
mLSTM's ``w_up`` column block of ``[u | z]`` is gathered and re-cut to the
rank's channels of u and of z (``parallel.column_pair``), the sLSTM's is
the rank's channels of u; the conv runs on those channels; u is gathered
over the model axes once (``gather_model``: each rank reads it only
through its own columns) for the column blocks of ``w_q`` / ``w_k`` /
``w_v`` / ``w_i`` / ``w_f`` (mLSTM) or ``w_z`` / ``w_i`` / ``w_f`` /
``w_o`` (sLSTM), which give the rank's heads; the recurrence runs on them
with the rank's ``f_bias`` and ``r_*`` blocks (the heads are independent:
no collective inside it); the output norm, an RMS over the whole d_in, sums
the rank's sum of squares over the model ranks (``enter_model(sum_model
(.))``: under autograd each rank reads the sum only through its own
channels, so its gradient is summed back); ``w_down``'s row block gives a
partial sum of the output. The sLSTM's input projections of all T steps
are computed before its time loop on the rank's head block, so not one
collective runs inside the T steps. Where the column blocks cut a head (H
not dividing by the model extent, d_in dividing: ``w_i``, ``w_f``, the
mLSTM's ``f_bias`` and the sLSTM's ``r_*`` stay whole), the projections'
columns are gathered over the model axes once, before the recurrence, and
every rank runs every head (as ``attention._heads`` does), the whole leaves
read inside entering the split block and the sLSTM's ``f_bias`` block
gathered; the row block then takes the rank's channels. The decode state
is the rank's heads (every head where they were gathered) and the rank's
channels of the conv window.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.device import DeviceLike, resolve_traced
from repro_torch.launch import cost_analysis
from repro_torch.models import attention, layers, parallel

Params = Dict[str, object]

# the chunkwise form's largest chunk (the reference's REPRO_MLSTM_CHUNK
# default); a chunk must divide the sequence
MLSTM_CHUNK = 128
_NEG_M = -1e30   # the stabilizer's start


def _dims(cfg: ModelConfig):
    x = cfg.xlstm or XLSTMConfig()
    d_in = int(x.proj_factor * cfg.d_model)
    return x, d_in, d_in // cfg.n_heads


def _split(params: Params, cfg: ModelConfig, par) -> Tuple[int, bool]:
    """(c, tp): the channels of d_in the block computes (``w_down``'s
    rows) and whether they are a block of d_in (the output then a partial
    sum over the model axes)."""
    _, d_in, _ = _dims(cfg)
    c = params["w_down"].shape[-2]
    return c, par is not None and c < d_in


def _channels(h: torch.Tensor, par, tp: bool, c: int, head0: int,
              hd: int) -> torch.Tensor:
    """This rank's ``c`` channels of ``h`` [..., h hd], whose heads start
    at head ``head0``: all of ``h`` unless the heads were gathered (or the
    block runs whole)."""
    if not tp or h.shape[-1] == c:
        return h
    c0 = par.model_index * c - head0 * hd
    return h[..., c0:c0 + c]


def _out_norm(params: Params, cfg: ModelConfig, h: torch.Tensor, par,
              tp: bool) -> torch.Tensor:
    """The RMS norm of ``h`` over the whole d_in; under ``tp`` ``h`` is the
    rank's channels (and ``o_norm/scale`` their block): the sum of squares
    summed over the model ranks, entering the channel block."""
    if not tp:
        return layers.rms_norm(params["o_norm"], h, cfg.norm_eps)
    _, d_in, _ = _dims(cfg)
    x32 = h.to(torch.float32)
    ss = par.enter_model(par.sum_model(x32.square().sum(-1, keepdim=True)))
    out = x32 * torch.rsqrt(ss / d_in + cfg.norm_eps)
    return (out * params["o_norm"]["scale"].to(torch.float32)).to(h.dtype)


def _down(params: Params, h: torch.Tensor, par, tp: bool) -> torch.Tensor:
    out = h @ params["w_down"]
    return par.sum_model(out) if tp else out


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


def _mlstm_gates_qkv(params: Params, cfg: ModelConfig, u: torch.Tensor,
                     par=None, tp: bool = False):
    """u: [B, T, c] after conv and silu -> q, k, v [B, T, h, hd] and the
    input / forget pre-activations [B, T, h] in fp32 at the heads this
    rank runs, and the first one's index. Without ``tp`` u has every
    channel and h = H; under it u is the rank's channels, gathered once,
    and the heads those of the column blocks (every head where they cut
    one: the columns gathered, the whole ``w_i`` / ``w_f`` / ``f_bias``
    entering the split block)."""
    _, _, hd = _dims(cfg)
    par = par if tp else None
    if par is not None:
        u = par.gather_model(u, -1)
    q, head0 = attention._heads(par, u, params["w_q"], cfg.n_heads, hd,
                                False)
    k, _ = attention._heads(par, u, params["w_k"], cfg.n_heads, hd, False)
    v, _ = attention._heads(par, u, params["w_v"], cfg.n_heads, hd, False)
    w_i, w_f, f_bias = params["w_i"], params["w_f"], params["f_bias"]
    if par is not None and q.shape[2] == cfg.n_heads:   # whole gate leaves
        w_i, w_f, f_bias = (par.enter_model(g) for g in (w_i, w_f, f_bias))
    i_pre = (u @ w_i).to(torch.float32)
    f_pre = (u @ w_f).to(torch.float32) + f_bias.to(torch.float32)
    return q, k * hd ** -0.5, v, i_pre, f_pre, head0


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
                  chunk: Optional[int] = None, par=None
                  ) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state). ``chunk`` as in
    :func:`mlstm_chunk`; ``par``: see the module docstring."""
    xcfg, d_in, hd = _dims(cfg)
    b, t, _ = x.shape
    c, tp = _split(params, cfg, par)
    u_raw, z = parallel.column_pair(par, x, params["w_up"], d_in, c, tp)
    u = F.silu(layers.causal_conv_apply(params["conv"], u_raw))
    q, k, v, i_pre, f_pre, head0 = _mlstm_gates_qkv(params, cfg, u, par, tp)
    nh = q.shape[2]
    carry = (torch.zeros((b, nh, hd, hd), device=x.device),
             torch.zeros((b, nh, hd), device=x.device),
             torch.full((b, nh), _NEG_M, device=x.device))
    chunk = mlstm_chunk(t, chunk)
    if chunk:
        carry, hs = _mlstm_chunkwise(q, k, v, i_pre, f_pre, carry, chunk)
    else:
        carry, hs = _mlstm_sequential(q, k, v, i_pre, f_pre, carry)
    hs = _channels(hs.reshape(b, t, nh * hd), par, tp, c, head0, hd)
    h = _out_norm(params, cfg, hs.to(x.dtype), par, tp)
    out = _down(params, h * F.silu(z), par, tp)
    return out, {"C": carry[0], "n": carry[1], "m": carry[2],
                 "conv": _conv_state(u_raw, xcfg.conv_width)}


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = "cuda") -> Params:
    """A zeroed mLSTM state on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    x, d_in, hd = _dims(cfg)
    device = resolve_traced(device)
    h = cfg.n_heads
    return {"C": torch.zeros((batch, h, hd, hd), device=device),
            "n": torch.zeros((batch, h, hd), device=device),
            "m": torch.full((batch, h), _NEG_M, device=device),
            "conv": torch.zeros((batch, x.conv_width - 1, d_in), dtype=dtype,
                                device=device)}


def mlstm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                 state: Params, par=None) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new state into ``state`` in place
    and returns it. ``par``: see the module docstring (``state`` then
    holds the rank's heads and channels)."""
    _, d_in, hd = _dims(cfg)
    c, tp = _split(params, cfg, par)
    u_raw, z = parallel.column_pair(par, x_t, params["w_up"], d_in, c, tp)
    u_c, conv_state = layers.causal_conv_step(params["conv"], state["conv"],
                                              u_raw)
    q, k, v, i_pre, f_pre, head0 = _mlstm_gates_qkv(
        params, cfg, F.silu(u_c)[:, None, :], par, tp)
    (C, n, m), h = _mlstm_step(
        (state["C"], state["n"], state["m"]),
        (q[:, 0].to(torch.float32), k[:, 0].to(torch.float32),
         v[:, 0].to(torch.float32), i_pre[:, 0], f_pre[:, 0]))
    h = _channels(h.reshape(x_t.shape[0], -1), par, tp, c, head0, hd)
    h = _out_norm(params, cfg, h.to(x_t.dtype), par, tp)
    out = _down(params, h * F.silu(z), par, tp)
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


class _SLSTMSteps(torch.autograd.Function):
    """The sLSTM's T steps on meta tensors under grad: ``forward(r_cat,
    f_bias, proj, c, n, m, h) -> (hs [B, T, H, hd], c, n, m, h)`` runs one
    step counted T times, and its stack; ``backward`` runs that step's
    backward (its carry requiring grad, as after the first step) counted
    T times, each with the engine's gradient of the step's slice of the
    projections (``select_backward``) and the sums of the steps'
    gradients."""

    @staticmethod
    def forward(ctx, r_cat, f_bias, proj, *carry):
        t = proj.shape[1]
        ins = [x.detach().requires_grad_(x.requires_grad)
               for x in (r_cat, f_bias, proj[:, 0])]
        ins += [x.detach().requires_grad_(True) for x in carry]
        # the step's graph keeps its own saved tensors: under a checkpoint
        # (``rounds._microbatched_grad``) they would be recomputed, the
        # whole checkpointed region with them, inside :meth:`backward`'s
        # count of T trips
        with torch.enable_grad(), cost_analysis.repeated(t), \
                torch.autograd.graph.saved_tensors_hooks(lambda x: x,
                                                         lambda x: x):
            out, h = _slstm_step_rec(ins[0], ins[1], tuple(ins[3:]), ins[2])
        ctx.step = (ins, out)
        ctx.shape = tuple(proj.shape)
        ctx.carry_grad = [x.requires_grad for x in carry]
        return (torch.stack([h.detach()] * t, dim=1),
                *(x.detach() for x in out))

    @staticmethod
    def backward(ctx, d_hs, *d_carry):
        ins, out = ctx.step
        shape, t = ctx.shape, ctx.shape[1]
        want = [i for i, x in enumerate(ins) if x.requires_grad]
        sums = {i: torch.zeros_like(ins[i]) for i in want if i != 2}
        d_proj = torch.zeros(shape, dtype=ins[2].dtype, device=d_hs.device)
        d_out = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(d_carry, out)]
        with cost_analysis.repeated(t):
            d_out[3] = d_out[3] + d_hs[:, 0]
            grads = torch.autograd.grad(out, [ins[i] for i in want], d_out,
                                        allow_unused=True)
            for i, g in zip(want, grads):
                if g is None:
                    continue
                if i == 2:   # the step's slice of the projections
                    d_proj = d_proj + torch.ops.aten.select_backward(
                        g, shape, 1, 0)
                else:
                    sums[i] = sums[i] + g
        res = [sums.get(i) for i in range(len(ins))]
        res[2] = d_proj if ins[2].requires_grad else None
        for k, needed in enumerate(ctx.carry_grad):
            if not needed:
                res[3 + k] = None
        return tuple(res)


def _slstm_steps_meta(r_cat, f_bias, proj, carry):
    """The sLSTM's T steps on meta tensors: (hs [B, T, H, hd], the final
    carry), one step counted T times (:class:`_SLSTMSteps` under grad)."""
    t = proj.shape[1]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r_cat, f_bias, proj, *carry)):
        hs, *carry = _SLSTMSteps.apply(r_cat, f_bias, proj, *carry)
        return hs, tuple(carry)
    with cost_analysis.repeated(t):
        carry, h = _slstm_step_rec(r_cat, f_bias, carry, proj[:, 0])
    return torch.stack([h] * t, dim=1), carry


def _slstm_heads(params: Params, cfg: ModelConfig, u: torch.Tensor, par,
                 tp: bool):
    """(the input projections [..., 4, h hd] of u at the heads the rank
    runs, their recurrent weights (:func:`_slstm_recurrent`) and
    ``f_bias`` [1, h, hd], the first one's index) from u [..., c] after
    conv and silu. Under ``tp`` u is the rank's channels, gathered once
    for the projections' column blocks; where those cut a head (``r_*``
    whole) the projections' columns and ``f_bias`` are gathered too and
    the whole ``r_*`` enter the split block."""
    _, _, hd = _dims(cfg)
    if tp:
        u = par.gather_model(u, -1)
    proj = _slstm_proj(params, u)
    rec, f_bias = params, params["f_bias"]
    nh, head0 = params["r_z"].shape[-3], 0
    if tp and nh == cfg.n_heads:       # the column blocks cut a head
        proj = par.gather_model(proj, -1)
        f_bias = par.gather_model(f_bias, -1)
        rec = {f"r_{g}": par.enter_model(params[f"r_{g}"]) for g in "zifo"}
    elif tp:
        head0 = par.model_index * nh
    return (proj, _slstm_recurrent(rec),
            f_bias.to(torch.float32).reshape(1, nh, hd), head0)


def _slstm_up(params: Params, x: torch.Tensor, par, tp: bool):
    """x @ ``w_up``: the rank's channels of u under ``tp`` (x entering the
    column block)."""
    return (par.enter_model(x) if tp else x) @ params["w_up"]


def slstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  par=None) -> Tuple[torch.Tensor, Params]:
    """x: [B, T, D] -> (out [B, T, D], final state): the input projections
    of all T steps first, then the recurrence step by step. ``par``: see
    the module docstring; every collective runs before the time loop or
    after it."""
    xcfg, d_in, hd = _dims(cfg)
    b, t, _ = x.shape
    c, tp = _split(params, cfg, par)
    u_raw = _slstm_up(params, x, par, tp)
    proj, r_cat, f_bias, head0 = _slstm_heads(params, cfg, F.silu(
        layers.causal_conv_apply(params["conv"], u_raw)), par, tp)
    shape = (b, f_bias.shape[1], hd)
    carry = (torch.zeros(shape, device=x.device),
             torch.zeros(shape, device=x.device),
             torch.full(shape, _NEG_M, device=x.device),
             torch.zeros(shape, device=x.device))
    if x.device.type == "meta":   # the dry-run: one step, counted t times
        hs, carry = _slstm_steps_meta(r_cat, f_bias, proj, carry)
    else:
        steps = []
        for step in range(t):
            carry, h = _slstm_step_rec(r_cat, f_bias, carry, proj[:, step])
            steps.append(h)
        hs = torch.stack(steps, dim=1)
    del proj
    h = _channels(hs.reshape(b, t, -1), par, tp, c, head0, hd)
    h = _out_norm(params, cfg, h.to(x.dtype), par, tp)
    return _down(params, h, par, tp), {
        "c": carry[0], "n": carry[1], "m": carry[2], "h": carry[3],
        "conv": _conv_state(u_raw, xcfg.conv_width)}


def init_slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = "cuda") -> Params:
    """A zeroed sLSTM state on ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    x, d_in, hd = _dims(cfg)
    device = resolve_traced(device)
    shape = (batch, cfg.n_heads, hd)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, _NEG_M, device=device),
            "h": torch.zeros(shape, device=device),
            "conv": torch.zeros((batch, x.conv_width - 1, d_in), dtype=dtype,
                                device=device)}


def slstm_decode(params: Params, cfg: ModelConfig, x_t: torch.Tensor,
                 state: Params, par=None) -> Tuple[torch.Tensor, Params]:
    """x_t: [B, D], one step. Writes the new state into ``state`` in place
    and returns it. ``par``: see the module docstring (``state`` then
    holds the rank's heads and channels)."""
    _, _, hd = _dims(cfg)
    c, tp = _split(params, cfg, par)
    u_c, conv_state = layers.causal_conv_step(
        params["conv"], state["conv"], _slstm_up(params, x_t, par, tp))
    proj, r_cat, f_bias, head0 = _slstm_heads(params, cfg, F.silu(u_c), par,
                                              tp)
    carry = (state["c"], state["n"], state["m"], state["h"])
    carry, h = _slstm_step_rec(r_cat, f_bias, carry, proj)
    h = _channels(h.reshape(x_t.shape[0], -1), par, tp, c, head0, hd)
    h = _out_norm(params, cfg, h.to(x_t.dtype), par, tp)
    for key, new in zip(("c", "n", "m", "h", "conv"), (*carry, conv_state)):
        state[key].copy_(new)
    return _down(params, h, par, tp), state
