"""Mixture-of-Experts MLP with capacity-based scatter dispatch (the JAX
package's ``models/moe.py``).

Expert weights are stacked ``[E, ...]``. :func:`route` makes the integer
decisions: softmax over the router logits, the top-k experts of each token
(the lower index first on equal probabilities, as ``jax.lax.top_k`` orders
them: a stable descending sort), the renormalised gates, the capacity and
each choice's slot in its expert. A choice whose slot reaches the capacity
is dropped: it goes to the overflow slot ``capacity``, which many tokens
write and none read. :func:`moe_apply` scatters the tokens into ``[E,
capacity + 1, D]``, runs each expert's FFN as a batched matmul, gathers
the kept choices back and weights them by their gates.

The reference zero-pads the experts' output with an overflow row; here the
overflow row of the input is zeroed after the scatter, and an expert's FFN
maps a zero row to zero (no biases), so the row it gathers for a dropped
choice is zero all the same, with no copy of the output.

On a mesh (``par``, ``models/parallel.py``) the experts split over the
model axes (``[E / m, ...]`` blocks) while the tokens are whole on every
model rank (split only over the batch axes): every model rank routes the
same tokens, dispatches only the choices whose expert lies in its block
(the others go to the overflow slot of its first expert, which is zeroed
and read back as zero), runs its experts, and combines its choices'
weighted outputs into a partial ``[T, D]`` that one all-reduce over the
model axes completes, the shared experts' partial (their hidden width
split over the model axes) joining the same sum. Capacity, slots, drops
and the aux loss are the unsplit function's: the routing is the same. So
expert parallelism here needs no all-to-all.

The capacity depends on the token count T, so a forward over S tokens and
prefill plus decode over the same tokens agree only when nothing is
dropped. Decode calls :func:`moe_apply` on ``[B, 1, D]``: T = B and the
capacity is at least 4, so every expert runs on its slots and a step reads
every expert's weights, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

Params = Dict[str, object]


class Routing(NamedTuple):
    """The router's decisions for T tokens and k choices each."""
    probs: torch.Tensor       # [T, E] softmax of the router logits
    gate_vals: torch.Tensor   # [T, k] renormalised gates
    gate_idx: torch.Tensor    # [T, k] int64 expert of each choice
    slots: torch.Tensor       # [T, k] int64 slot, ``capacity`` if dropped
    keeps: torch.Tensor       # [T, k] bool, the choice kept
    capacity: int
    # [T', k] every rank's choices in row order (T' = T on one device)
    every: Optional[torch.Tensor] = None


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    m, d = cfg.moe, cfg.d_model
    scale = d ** -0.5

    def stack(din, dout):
        return layers.dense_init(generator, din, dout, dtype, scale,
                                 lead=(*lead, m.n_experts))

    p: Params = {
        "router": layers.dense_init(generator, d, m.n_experts, torch.float32,
                                    lead=lead),
        "w_in": stack(d, m.d_ff),
        "w_out": stack(m.d_ff, d),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = stack(d, m.d_ff)
    if m.n_shared:
        p["shared"] = layers.mlp_init(generator, d, m.n_shared * m.d_ff,
                                      cfg.mlp, dtype, lead)
    return p


def capacity_of(cfg: ModelConfig, t: int) -> int:
    """Slots an expert has for T tokens, in Python floats as the reference
    computes it."""
    m = cfg.moe
    return max(int(t * m.top_k * m.capacity_factor / m.n_experts), 4)


def route(logits: torch.Tensor, cfg: ModelConfig, par=None) -> Routing:
    """logits: [T, E] fp32 router logits -> the routing of the T tokens.
    Slots are given one routing choice at a time: choice j of a token
    ranks after every choice j' < j and after choice j of earlier tokens.
    Makes no host sync. ``par`` (``models/parallel.py``, the tokens' rows
    split over its batch axes): the slots and the capacity are those of
    every rank's tokens in row order, from their gathered choices, so
    each rank keeps and drops what one device would."""
    m = cfg.moe
    t, n_exp = logits.shape
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :m.top_k], idx[:, :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    by_rows = par is not None and bool(par.batch_axes)
    every = par.gather_batch(gate_idx) if by_rows else gate_idx
    capacity = capacity_of(cfg, every.shape[0])

    experts = torch.arange(n_exp, device=logits.device)
    counts = torch.zeros(n_exp, dtype=torch.int64, device=logits.device)
    slot_list, keep_list = [], []
    for j in range(m.top_k):
        e_j = every[:, j]                                          # [T]
        onehot = (e_j[:, None] == experts).to(torch.int64)          # [T, E]
        ranks = onehot.cumsum(0) - 1          # rank among this choice
        slot = ranks.gather(1, e_j[:, None])[:, 0] + counts[e_j]
        keep = slot < capacity
        slot_list.append(torch.where(keep, slot, capacity))
        keep_list.append(keep)
        counts = counts + onehot.sum(0)
    slots, keeps = torch.stack(slot_list, 1), torch.stack(keep_list, 1)
    if by_rows:
        rows = slice(par.batch_index * t, (par.batch_index + 1) * t)
        slots, keeps = slots[rows], keeps[rows]
    return Routing(probs, gate_vals, gate_idx, slots, keeps, capacity,
                   every)


def _expert_ffn(p: Params, h: torch.Tensor, kind: str) -> torch.Tensor:
    """h: [E, C, D] -> [E, C, D] through each expert's FFN (batched)."""
    up = torch.bmm(h, p["w_in"])
    if kind == "swiglu":
        up = F.silu(torch.bmm(h, p["w_gate"])) * up
    elif kind == "geglu":
        up = F.gelu(torch.bmm(h, p["w_gate"]), approximate="tanh") * up
    elif kind == "squared_relu":
        up = F.relu(up).square()
    elif kind == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return torch.bmm(up, p["w_out"])


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
              drops: Optional[List[Tuple[int, torch.Tensor]]] = None,
              par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], the Switch-style load-balance aux
    loss, a scalar). With ``drops`` given, appends (the call's T * k
    assignments, the count dropped as a device tensor): no host sync.
    ``par``: x is this rank's block of rows (when the batch axes split
    them), routed with every rank's (:func:`route`); the aux loss is then
    this rank's tokens' own (the serve steps discard it), or under
    ``par.batch_loss`` (the train step's L2 layout) the whole batch's, the
    same on every rank: the top choices' shares from every rank's choices
    (which ``route`` gathered), the mean router probabilities summed over
    the batch ranks (``par.sum_batch``). With the experts split over the
    model axes (the module docstring) the dispatched tokens and the gates
    enter the expert block (``par.enter_model``: under autograd their
    gradients, partial on each rank, are summed)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    r = route(xt.to(torch.float32) @ params["router"], cfg, par)
    if drops is not None:
        drops.append((t * m.top_k, (~r.keeps).sum()))
    n_local = params["w_in"].shape[0]
    ep = par is not None and n_local < m.n_experts
    idx, slots, keeps, gates, xd = (r.gate_idx, r.slots, r.keeps,
                                    r.gate_vals, xt)
    if ep:   # this rank's experts' choices; the others to a discarded slot
        local = idx - par.model_index * n_local
        mine = (local >= 0) & (local < n_local)
        idx = torch.where(mine, local, 0)
        slots = torch.where(mine, slots, r.capacity)
        keeps = keeps & mine
        xd, gates = par.enter_model(xt), par.enter_model(gates)

    # dispatch: scatter tokens into [E, C + 1, D], slot C the overflow bin
    buf = x.new_zeros((n_local, r.capacity + 1, d))
    buf.index_put_((idx, slots), xd[:, None, :].expand(t, m.top_k, d))
    buf[:, r.capacity] = 0
    expert_out = _expert_ffn(params, buf, cfg.mlp)       # overflow rows 0

    # combine: gather back, weight by the (renormalised) gates
    gathered = expert_out[idx, slots]                           # [T, k, D]
    w = (gates * keeps.to(gates.dtype)).to(x.dtype)
    out = torch.einsum("tkd,tk->td", gathered, w)
    shared = None
    if m.n_shared:   # its partial joins the experts' sum where both split
        sh = params["shared"]
        sh_split = par is not None \
            and sh["w_out"].shape[0] < m.n_shared * m.d_ff
        shared = layers.mlp_apply(sh, xt, cfg.mlp, par if sh_split else None,
                                  reduce=not ep)
        if ep and sh_split:
            out, shared = out + shared, None
    if ep:
        out = par.sum_model(out)
    if shared is not None:
        out = out + shared

    experts = torch.arange(m.n_experts, device=x.device)
    if par is not None and par.batch_loss:
        every = r.every[:, 0, None]
        frac_tokens = (every == experts).to(torch.float32).mean(0)
        frac_probs = par.sum_batch(r.probs.sum(0)) / every.shape[0]
    else:
        frac_tokens = (r.gate_idx[:, 0, None] == experts).to(
            torch.float32).mean(0)
        frac_probs = r.probs.mean(0)
    aux = m.n_experts * (frac_tokens * frac_probs).sum() * m.aux_loss_weight
    return out.reshape(b, s, d), aux
