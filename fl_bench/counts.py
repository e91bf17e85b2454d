"""The work a cell's training job needs, counted from its shapes: the
operations of a round of the model and the bytes and operations of each
kernel call, whatever implements it. Every roofline and ``mfu`` divides by
these, so they count the algorithm's work once: a recompute, a second
pass or a wider copy is time the share shows, not work it credits.

``widths`` is a configuration file's dict, ``traffic`` a traffic file's;
what depends on the kind of model comes from the configuration's family
(``fl_bench/families``).
"""
from __future__ import annotations

import math
from typing import Mapping

F32 = 4


def _family(widths: Mapping):
    from fl_bench import families
    return families.load(widths["family"])


def causal_pairs(seq: int) -> int:
    """Kept (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) // 2


def round_flops(widths: Mapping, traffic: Mapping) -> float:
    """A round: each client's tau forward and backward passes (the
    backward twice the forward) and one forward of the global loss."""
    f = _family(widths).forward_flops(widths, traffic["sequences"],
                                      traffic["seq"])
    spec = traffic["spec"]
    return spec["n_clients"] * (3 * spec["tau"] + 1) * f


def round_tokens(traffic: Mapping) -> int:
    """Tokens trained on in a round: every client's tokens, tau times."""
    spec = traffic["spec"]
    return (spec["n_clients"] * traffic["sequences"] * traffic["seq"]
            * spec["tau"])


def flash_call(widths: Mapping, traffic: Mapping, backward: bool,
               lse: bool = True):
    """(flops, bytes) of one attention call on one client's batch at
    [B, S, H, D]: the forward 4 D a kept pair a head (QK^T and PV), the
    backward 8 D (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q; a
    recompute of S is not the gradient's work), every fp32 input and
    output read or written once. A forward under grad (``lse``) also
    writes the rows' logsumexp; the backward reads q, k, v, o, the
    logsumexp and dO and writes dQ, dK and dV."""
    b, s = traffic["sequences"], traffic["seq"]
    h, hkv, d = widths["n_heads"], widths["n_kv_heads"], widths["head_dim"]
    pairs = b * h * causal_pairs(s)
    q = b * s * h * d * F32
    kv = b * s * hkv * d * F32
    rows = b * h * s * F32
    if backward:
        return 8.0 * d * pairs, 4 * q + 4 * kv + rows
    return 4.0 * d * pairs, 2 * q + 2 * kv + (rows if lse else 0)


def leaf_sizes(widths: Mapping):
    """Every leaf's number of floats (one model)."""
    return [math.prod(s) for s in
            _family(widths).reference.leaf_shapes(widths).values()]


def fedavg_bytes(widths: Mapping, clients: int) -> float:
    """A round's FedAvg over every leaf: the C rows and the weights read,
    the C rows written."""
    return sum(F32 * (2 * clients * n + clients) for n in leaf_sizes(widths))


def digest_bytes(widths: Mapping, clients: int) -> float:
    """A round's digest and divergence sweep over every leaf: the C rows
    read, the leaf's sum and its C residuals written."""
    return sum(F32 * (clients * n + 1 + clients) for n in leaf_sizes(widths))
