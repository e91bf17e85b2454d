"""Decentralized model aggregation (paper §3.1 Steps 2+5).

Every client broadcasts its model and every client computes the same
aggregate: the mean over the leading client axis, re-broadcast to every
client slot. On one GPU that is one pass of the hand-written FedAvg kernel
per leaf (``kernels/fedavg``).

The ``mix_*`` family are the single-device forms (the JAX package's
``axis_name=None``) of the topology mixes that ``rounds.make_communicate``
runs for each resolved ``MixPlan.mode``:

  ``mix_all_reduce``   FullMesh: ``fedavg`` (the FedAvg kernel)
  ``mix_rolls``        neighbor windows and pair shifts: rolls of the client
                       axis, raw sum then one scale (the one-device form of
                       the JAX package's ``mix_neighbor_halo`` and
                       ``mix_shift_halo``)
  ``mix_gather``       any dense W: ``torch.matmul``, or with
                       ``use_kernel=True`` the ``mix_rows_flat`` kernel
  ``mix_segment``      sparse edge lists: gather + ``index_add_``
  ``mix_cluster``      two-level cluster mean + ring of cluster means

and the robust reducers ``robust_median`` / ``robust_trimmed`` /
``robust_geomedian`` (the JAX package's ``mix_median`` / ``mix_trimmed`` /
``mix_geomedian``): Byzantine-robust consensus over the whole broadcast
set (order statistics, Weiszfeld geometric median).

Every mix accumulates in float32 and returns each leaf in its own dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.fedavg import ops as fedavg_ops

Tree = Dict[str, torch.Tensor]


def fedavg(params: Tree, weights: Optional[torch.Tensor] = None) -> Tree:
    """Mean (optionally weighted by |D_i|) over the leading client axis C,
    broadcast back to every client: returns a same-shaped dict. Runs the
    CUDA FedAvg kernel on GPU tensors.

    >>> import torch
    >>> out = fedavg({"w": torch.tensor([[0.0], [2.0], [4.0]])})
    >>> [float(v) for v in out["w"].ravel()]
    [2.0, 2.0, 2.0]
    """
    return fedavg_ops.fedavg_tree(params, weights)


def aggregate_once(params: Tree, weights: Optional[torch.Tensor] = None) -> Tree:
    """Mean over the client axis WITHOUT re-broadcast (one global model)."""
    out = {}
    for k in sorted(params):
        leaf = params[k].to(torch.float32)
        if weights is None:
            agg = leaf.mean(dim=0)
        else:
            w = (weights / weights.sum()).to(torch.float32)
            agg = torch.tensordot(w, leaf, dims=([0], [0]))
        out[k] = agg.to(params[k].dtype)
    return out


def replicate(params: Tree, n_clients: int) -> Tree:
    """Lift a single model to the client axis (round-0 initialization);
    every client gets its own copy."""
    return {k: v.unsqueeze(0).repeat((n_clients,) + (1,) * v.dim())
            for k, v in params.items()}


def client_divergence(params: Tree) -> torch.Tensor:
    """Root-mean over clients of each client's squared L2 distance from
    the client average: the diagnostic for the gradient divergence delta of
    Definition 1. Plain PyTorch; the round computes it with the fused sweep
    of ``kernels/fedavg`` instead."""
    total = None
    for k in sorted(params):
        x = params[k].to(torch.float32)
        sq = ((x - x.mean(dim=0, keepdim=True)) ** 2).reshape(x.shape[0], -1)
        total = sq.sum(dim=1) if total is None else total + sq.sum(dim=1)
    return torch.sqrt(total.mean())


def _f32(value: float) -> float:
    """A Python float rounded to float32, so a scale is the JAX package's
    ``jnp.float32(value)`` whichever precision torch multiplies in."""
    return float(np.float32(value))


def _reweight_rows(W: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    """|D_i| row reweighting shared by the dense mixes:
    ``W'[i, j] ∝ W[i, j] * weights[j]``, renormalized per row."""
    W = W.to(torch.float32)
    if weights is None:
        return W
    W = W * weights.to(torch.float32)[None, :]
    return W / W.sum(dim=1, keepdim=True)


def mix(params: Tree, W: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> Tree:
    """Client i adopts ``sum_j W[i, j] * params_j`` for a row-stochastic
    ``W [C, C]`` on the params' device, optionally reweighted by |D_j|."""
    W = _reweight_rows(W, weights)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        flat = leaf.to(torch.float32).reshape(leaf.shape[0], -1)
        out[k] = torch.matmul(W, flat).reshape(leaf.shape).to(leaf.dtype)
    return out


def mix_all_reduce(params: Tree,
                   weights: Optional[torch.Tensor] = None) -> Tree:
    """FullMesh: every client adopts the (weighted) client mean."""
    return fedavg(params, weights)


def mix_rolls(params: Tree, offsets: Sequence[int], weight: float) -> Tree:
    """Client ``i`` adopts ``weight * sum_off params[(i + off) % C]``, the
    offsets summed raw in the given order and scaled once at the end.

    >>> import torch
    >>> out = mix_rolls({"w": torch.arange(4.0).reshape(4, 1)},
    ...                 offsets=(-1, 0, 1), weight=1.0 / 3.0)
    >>> [round(float(v), 4) for v in out["w"].ravel()]
    [1.3333, 1.0, 2.0, 1.6667]
    """
    w = _f32(weight)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        acc = torch.roll(x, -offsets[0], dims=0)
        for off in offsets[1:]:
            acc = acc + torch.roll(x, -off, dims=0)
        out[k] = (acc * w).to(leaf.dtype)
    return out


def mix_gather(params: Tree, W: torch.Tensor,
               weights: Optional[torch.Tensor] = None, *,
               use_kernel: bool = False) -> Tree:
    """Any dense ``W``: ``torch.matmul`` per leaf, or with ``use_kernel``
    (``RoundSpec.fused_mix``) the ``mix_rows_flat`` kernel on the
    reweighted rows (its plain version on CPU tensors)."""
    if use_kernel:
        return fedavg_ops.mix_rows_tree(
            params, _reweight_rows(W, weights).contiguous())
    return mix(params, W, weights)


def mix_segment(params: Tree, neighbor_idx: torch.Tensor,
                edge_w: torch.Tensor) -> Tree:
    """Sparse mix over ``[C, D]`` edge lists (``topology.SparseLowering``
    on the params' device): client ``i`` adopts ``sum_d edge_w[i, d] *
    params[neighbor_idx[i, d]]``, as a gather of the neighbor rows and an
    ``index_add_`` into the outputs, O(C * D) per column.

    >>> import torch
    >>> out = mix_segment({"w": torch.arange(3.0).reshape(3, 1)},
    ...                   torch.tensor([[0, 1], [0, 1], [2, 2]]),
    ...                   torch.tensor([[0.5, 0.5], [0.5, 0.5], [1.0, 0.0]]))
    >>> [float(v) for v in out["w"].ravel()]
    [0.5, 0.5, 2.0]
    """
    c, d = neighbor_idx.shape
    seg = torch.arange(c, device=neighbor_idx.device).repeat_interleave(d)
    src = neighbor_idx.reshape(-1).to(torch.int64)
    w = edge_w.reshape(-1, 1).to(torch.float32)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        flat = leaf.to(torch.float32).reshape(c, -1)
        gathered = flat.index_select(0, src) * w
        mixed = torch.zeros_like(flat).index_add_(0, seg, gathered)
        out[k] = mixed.reshape(leaf.shape).to(leaf.dtype)
    return out


def mix_cluster(params: Tree, n_clusters: int, inter_weight: float) -> Tree:
    """Two-level ``ClusterTopology`` mix: each of the ``G`` contiguous
    clusters reduces to its mean (raw sum, then one scale), the means mix
    on the cluster ring ``(1 - a) * m + a/2 * prev + a/2 * next``, and
    every client of a cluster adopts its cluster's result.

    >>> import torch
    >>> out = mix_cluster({"w": torch.arange(4.0).reshape(4, 1)}, 2, 0.0)
    >>> [float(v) for v in out["w"].ravel()]
    [0.5, 0.5, 2.5, 2.5]
    """
    g = int(n_clusters)
    w_self = _f32(1.0 - inter_weight)
    w_nbr = _f32(inter_weight / 2.0)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        s = x.shape[0] // g
        grp = x.reshape((g, s) + x.shape[1:])
        m = grp.sum(dim=1) * _f32(1.0 / s)
        mixed = (m * w_self + torch.roll(m, 1, dims=0) * w_nbr
                 + torch.roll(m, -1, dims=0) * w_nbr)
        out[k] = mixed.unsqueeze(1).expand(grp.shape).reshape(x.shape) \
            .to(leaf.dtype)
    return out


# ---------------------------------------------------------------------------
# Robust consensus reducers (RoundSpec.robust_agg). Each maps the broadcast
# set [C, ...] to ONE aggregate every client adopts, over the whole client
# axis whatever the topology: a Byzantine row is excluded per coordinate,
# not down-weighted. Breakdown points: median and geometric median
# floor((C-1)/2), trimmed(t) t per tail, against 0 for every linear mix.
# ---------------------------------------------------------------------------


def _broadcast(agg: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return agg.unsqueeze(0).expand(leaf.shape).to(leaf.dtype).contiguous()


def median0(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 with ``jnp.median``'s rule: for an even count the
    two middle values ``(lo + hi) * 0.5`` (``torch.median`` returns
    ``lo``)."""
    srt = x.sort(dim=0).values
    h = srt.shape[0] // 2
    return srt[h] if srt.shape[0] % 2 else (srt[h - 1] + srt[h]) * 0.5


def robust_median(full_tree: Tree) -> Tree:
    """Coordinate-wise median over the client axis (:func:`median0`),
    broadcast to every client.

    >>> import torch
    >>> out = robust_median({"w": torch.tensor([[0.0], [1.0], [100.0]])})
    >>> [float(v) for v in out["w"].ravel()]
    [1.0, 1.0, 1.0]
    """
    return {k: _broadcast(median0(v.to(torch.float32)), v)
            for k, v in full_tree.items()}


def robust_trimmed(full_tree: Tree, trim: int) -> Tree:
    """Coordinate-wise trimmed mean: drop the ``trim`` smallest and largest
    values of each coordinate, average the remaining ``C - 2 * trim``.

    >>> import torch
    >>> out = robust_trimmed({"w": torch.tensor([[0.0], [1.0], [2.0],
    ...                                          [1000.0]])}, trim=1)
    >>> [float(v) for v in out["w"].ravel()]
    [1.5, 1.5, 1.5, 1.5]
    """
    t = int(trim)
    out = {}
    for k in sorted(full_tree):
        leaf = full_tree[k]
        c = leaf.shape[0]
        if not 0 <= 2 * t < c:
            raise ValueError(f"trim={t} must satisfy 2*trim < C={c}")
        kept = leaf.to(torch.float32).sort(dim=0).values[t:c - t]
        out[k] = _broadcast(kept.sum(dim=0) / _f32(c - 2 * t), leaf)
    return out


def robust_geomedian(full_tree: Tree, n_iters: int = 8,
                     eps: float = 1e-6) -> Tree:
    """Geometric median of the flattened client models (all leaves in
    sorted key order) by ``n_iters`` Weiszfeld iterations from the mean;
    ``eps`` floors each distance so an iterate on a client point stays
    finite."""
    keys = sorted(full_tree)
    c = full_tree[keys[0]].shape[0]
    flat = torch.cat([full_tree[k].to(torch.float32).reshape(c, -1)
                      for k in keys], dim=1)
    y = flat.mean(dim=0)
    for _ in range(int(n_iters)):
        d = ((flat - y.unsqueeze(0)) ** 2).sum(dim=1).sqrt()
        w = 1.0 / d.clamp_min(_f32(eps))
        w = w / w.sum()
        y = torch.matmul(w, flat)
    out, at = {}, 0
    for k in keys:
        leaf = full_tree[k]
        size = leaf[0].numel()
        out[k] = _broadcast(y[at:at + size].reshape(leaf.shape[1:]), leaf)
        at += size
    return out
