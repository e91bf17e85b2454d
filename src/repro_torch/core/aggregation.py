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

Client-sharded forms
--------------------

Every mix takes ``mesh``, a ``launch.mesh.ClientMesh`` (the JAX package's
``axis_name`` and ``n_shards``). With ``mesh=None`` it is the one-device
math above; with a mesh, ``params`` hold this rank's ``C/D`` client rows
and the mix runs over the ranks' collectives, in one of two tiers:

  gather tier (bitwise with one process): the broadcast set is
      all-gathered (``client_all_gather``; pass the round's gathered tree
      as ``full`` to reuse it), the same full-width math runs on every
      rank, and each keeps its rows (``client_local_rows``). The halo
      mixes (``mix_neighbor_halo``, ``mix_shift_halo``) shift whole
      blocks between ranks and sum them in ``mix_rolls``' order;
      ``mix_cluster`` on a ``("pod", "data")`` mesh with one pod a
      cluster gathers inside a pod and shifts the cluster means across
      pods. ``mix_gather`` with ``use_kernel`` computes only the local
      rows, ``mix_rows_flat`` at R = C/D, K = C.
  psum tier (``RoundSpec.fast_allreduce``; tolerance): ``mix_psum`` sums
      locally pre-weighted rows over the ranks (one model-sized
      all-reduce), ``mix_psum_dense`` sums each rank's column-block
      product ``W[:, local] @ local`` (``mix_rows_flat`` at R = C, K = C/D
      with ``use_kernel``), and ``client_divergence_psum`` finishes the
      divergence from summed partials. Summing partials reassociates the
      fp32 reduction, so these agree with the gather tier to a tolerance
      and the ledger forks.

On a ``("data", "model")`` mesh (the train step, ``launch/steps.py``)
each client's params are further split into blocks (:class:`ModelBlocks`:
over model under the L1 layout; over data, model or both under L2).
Every mix here is coordinate-wise, so it runs on each leaf's block
unchanged: clients mix with clients, and the block needs no collective.
The diagnostics that reduce over a whole leaf (the digest's leaf sums,
the divergence's residuals) take the blocks' partials summed by
:meth:`ModelBlocks.sum`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.fedavg import ops as fedavg_ops

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Client-axis collectives
# ---------------------------------------------------------------------------


class ModelBlocks:
    """The axes that split each client's params, as the round sees them:
    each client's leaves in ``split`` are this rank's block of the leaf
    over ``mesh`` (a ``launch.mesh.ClientMesh``); every other leaf is
    whole on each rank, a replica. ``split`` maps each split key to the
    axes of ``mesh`` its block is split over: the model axes under the L1
    layout; the FSDP axes, the model axes or both under L2.

    :meth:`sum` adds a split leaf's per-block partials over exactly the
    axes that leaf is split over, in block order (an all-gather of the
    partials, then a sum in a Python loop: the same bits on every rank
    whatever the backend's reduction order), and leaves a replicated
    leaf's as they are. Summed over more axes than split it, a partial
    would be counted once a replica."""

    def __init__(self, mesh, split):
        self.mesh, self.split = mesh, dict(split)

    def sum(self, key: str, x: torch.Tensor) -> torch.Tensor:
        if key not in self.split:
            return x
        # repro-lint: disable=RL302
        parts = self.mesh.all_gather(x.reshape(1, -1), self.split[key],
                                     dim=0)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc.reshape(x.shape)


def client_gather(x: torch.Tensor, mesh=None,
                  axis: Optional[str] = None) -> torch.Tensor:
    """The full client axis of a per-client tensor on every rank (the
    ranks of the mesh, or of one of its axes), the ranks' blocks
    concatenated in rank order; ``x`` itself without a mesh. The one place
    the port gathers: the JAX package pins its gathers with an
    ``optimization_barrier`` so that XLA cannot fuse a reduction across
    them, and eager torch has no such fusion, the gathered tensor is
    materialized."""
    if mesh is None:
        return x
    # repro-lint: disable=RL302
    return mesh.all_gather(x, axis)


def client_all_gather(tree: Tree, mesh=None) -> Tree:
    """Every leaf's full ``[C, ...]`` client axis on every rank, the ranks'
    blocks concatenated in rank order: the array one process holds. The
    tree itself when ``mesh`` is None."""
    if mesh is None:
        return tree
    return {k: client_gather(tree[k], mesh) for k in sorted(tree)}


def client_shard_index(mesh=None) -> int:
    """Linear index of this rank's client block (row-major over the mesh
    axes, the order :func:`client_all_gather` concatenates); 0 without a
    mesh."""
    return 0 if mesh is None else mesh.shard_index


def client_local_rows(full_tree: Tree, mesh=None) -> Tree:
    """This rank's block of full ``[C, ...]`` leaves (the inverse of
    :func:`client_all_gather`); the tree itself without a mesh."""
    if mesh is None:
        return full_tree
    idx, n = client_shard_index(mesh), mesh.n_shards
    out = {}
    for k, leaf in full_tree.items():
        local = leaf.shape[0] // n
        out[k] = leaf[idx * local:(idx + 1) * local]
    return out


def _local_block(v: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``v`` along ``dim`` (rows of a ``[C]`` weight
    vector or of ``W``, or its columns)."""
    local = v.shape[dim] // mesh.n_shards
    return v.narrow(dim, client_shard_index(mesh) * local, local)


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


def mix_all_reduce(params: Tree, weights: Optional[torch.Tensor] = None,
                   *, mesh=None, full: Optional[Tree] = None) -> Tree:
    """FullMesh: every client adopts the (weighted) client mean. Sharded,
    the FedAvg kernel runs on the gathered set on every rank and each
    keeps its rows, bitwise the one-process mix."""
    if mesh is None:
        return fedavg(params, weights)
    full = client_all_gather(params, mesh) if full is None else full
    return client_local_rows(fedavg(full, weights), mesh)


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


def mix_neighbor_halo(params: Tree, offsets: Sequence[int], weight: float,
                      mesh=None) -> Tree:
    """The ring's halo on a mesh: each rank takes the blocks of its two
    ring neighbours (one batch of shifts), and window-sums its own clients
    in ``offsets`` order, raw sum then one scale, so the result is bitwise
    :func:`mix_rolls`. Needs ``max |off| <= C/D``. A ``("pod", "data")``
    mesh is one linear ring of ranks."""
    if mesh is None:
        return mix_rolls(params, offsets, weight)
    w = _f32(weight)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        local = x.shape[0]
        nxt, prv = mesh.shift(x, (1, -1))
        ext = torch.cat([prv, x, nxt], dim=0)   # rows -local .. 2 local
        acc = ext[local + offsets[0]:2 * local + offsets[0]]
        for off in offsets[1:]:
            acc = acc + ext[local + off:2 * local + off]
        out[k] = (acc * w).to(leaf.dtype)
    return out


def mix_shift_halo(params: Tree, offsets: Sequence[int], weight: float,
                   mesh=None) -> Tree:
    """:func:`mix_neighbor_halo` for any static offsets: offset ``s =
    q L + m`` over the block size ``L`` needs the blocks of ranks ``d + q``
    and ``d + q + 1``, so each offset is at most two whole-block shifts and
    a slice, O(1) blocks a round whatever C. Bitwise :func:`mix_rolls`."""
    if mesh is None:
        return mix_rolls(params, offsets, weight)
    n_dev = mesh.n_shards
    w = _f32(weight)

    def rows_at(x, s):
        local = x.shape[0]
        q, m = divmod(s % (local * n_dev), local)
        if m == 0:
            return mesh.shift(x, (q,))[0]
        lo, hi = mesh.shift(x, (q, q + 1))
        return torch.cat([lo, hi], dim=0)[m:m + local]

    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        acc = rows_at(x, offsets[0])
        for off in offsets[1:]:
            acc = acc + rows_at(x, off)
        out[k] = (acc * w).to(leaf.dtype)
    return out


def mix_gather(params: Tree, W: torch.Tensor,
               weights: Optional[torch.Tensor] = None, *, mesh=None,
               full: Optional[Tree] = None,
               use_kernel: bool = False) -> Tree:
    """Any dense ``W``: ``torch.matmul`` per leaf, or with ``use_kernel``
    (``RoundSpec.fused_mix``) the ``mix_rows_flat`` kernel on the
    reweighted rows (its plain version on CPU tensors).

    Sharded: the plain form applies ``W`` to the gathered set on every
    rank and keeps the local rows, bitwise one process; the kernel form
    takes this rank's rows of the reweighted ``W`` and computes only its
    own outputs, ``mix_rows_flat`` at R = C/D, K = C, whose per-row sums
    are the R = C launch's."""
    if use_kernel:
        w_rows = _reweight_rows(W, weights)
        if mesh is not None:
            params = client_all_gather(params, mesh) if full is None \
                else full
            w_rows = _local_block(w_rows, mesh)
        return fedavg_ops.mix_rows_tree(params, w_rows.contiguous())
    if mesh is None:
        return mix(params, W, weights)
    full = client_all_gather(params, mesh) if full is None else full
    return client_local_rows(mix(full, W, weights), mesh)


def mix_segment(params: Tree, neighbor_idx: torch.Tensor,
                edge_w: torch.Tensor, *, mesh=None,
                full: Optional[Tree] = None) -> Tree:
    """Sparse mix over ``[C, D]`` edge lists (``topology.SparseLowering``
    on the params' device): client ``i`` adopts ``sum_d edge_w[i, d] *
    params[neighbor_idx[i, d]]``, as a gather of the neighbor rows and an
    ``index_add_`` into the outputs, O(C * D) per column. Sharded, each
    rank takes its rows of the edge lists, gathers their neighbours out of
    the gathered set and sums into its own outputs only.

    >>> import torch
    >>> out = mix_segment({"w": torch.arange(3.0).reshape(3, 1)},
    ...                   torch.tensor([[0, 1], [0, 1], [2, 2]]),
    ...                   torch.tensor([[0.5, 0.5], [0.5, 0.5], [1.0, 0.0]]))
    >>> [float(v) for v in out["w"].ravel()]
    [0.5, 0.5, 2.0]
    """
    source = params
    if mesh is not None:
        source = client_all_gather(params, mesh) if full is None else full
        neighbor_idx = _local_block(neighbor_idx, mesh)
        edge_w = _local_block(edge_w, mesh)
    rows, d = neighbor_idx.shape
    seg = torch.arange(rows, device=neighbor_idx.device).repeat_interleave(d)
    src = neighbor_idx.reshape(-1).to(torch.int64)
    w = edge_w.reshape(-1, 1).to(torch.float32)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        flat = source[k].to(torch.float32).reshape(source[k].shape[0], -1)
        gathered = flat.index_select(0, src) * w
        mixed = torch.zeros((rows, flat.shape[1]), dtype=torch.float32,
                            device=flat.device).index_add_(0, seg, gathered)
        out[k] = mixed.reshape(leaf.shape).to(leaf.dtype)
    return out


def mix_cluster(params: Tree, n_clusters: int, inter_weight: float, *,
                mesh=None, full: Optional[Tree] = None) -> Tree:
    """Two-level ``ClusterTopology`` mix: each of the ``G`` contiguous
    clusters reduces to its mean (raw sum, then one scale), the means mix
    on the cluster ring ``(1 - a) * m + a/2 * prev + a/2 * next``, and
    every client of a cluster adopts its cluster's result.

    On a ``("pod", "data")`` mesh with ``G`` pods (``launch.mesh
    .make_cluster_mesh``) a cluster is a pod: its sum is an all-gather of
    the ``S`` rows inside the pod, reduced as the one-device ``[G, S,
    ...]`` sum reduces each cluster, and the ring takes two model-sized
    shifts of the cluster mean across pods, O(S + 2) models moved where
    the gather moves O(C); a ``full`` set the round gathered already gives
    the pod's rows without another gather. Any other mesh runs the
    one-device math on the gathered set.

    >>> import torch
    >>> out = mix_cluster({"w": torch.arange(4.0).reshape(4, 1)}, 2, 0.0)
    >>> [float(v) for v in out["w"].ravel()]
    [0.5, 0.5, 2.5, 2.5]
    """
    g = int(n_clusters)
    w_self = _f32(1.0 - inter_weight)
    w_nbr = _f32(inter_weight / 2.0)

    def dense(tree):
        out = {}
        for k in sorted(tree):
            leaf = tree[k]
            x = leaf.to(torch.float32)
            s = x.shape[0] // g
            grp = x.reshape((g, s) + x.shape[1:])
            m = grp.sum(dim=1) * _f32(1.0 / s)
            mixed = (m * w_self + torch.roll(m, 1, dims=0) * w_nbr
                     + torch.roll(m, -1, dims=0) * w_nbr)
            out[k] = mixed.unsqueeze(1).expand(grp.shape) \
                .reshape(x.shape).to(leaf.dtype)
        return out

    if mesh is None:
        return dense(params)
    aligned = len(mesh.axis_names) == 2 and mesh.shape[0] == g
    if not aligned:
        full = client_all_gather(params, mesh) if full is None else full
        return client_local_rows(dense(full), mesh)
    pod_axis, data_axis = mesh.axis_names
    pod = mesh.coord(pod_axis)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        if full is None:
            blk = client_gather(x, mesh, data_axis)   # the pod's S rows
        else:   # the round gathered the whole set already: its pod's rows
            s = full[k].shape[0] // g
            blk = full[k][pod * s:(pod + 1) * s].to(torch.float32)
        s = blk.shape[0]
        # a [1, S, ...] reduce over dim 1: the dense [G, S, ...] one's
        m = blk.reshape((1, s) + blk.shape[1:]).sum(dim=1)[0] \
            * _f32(1.0 / s)
        nxt, prv = mesh.shift(m, (1, -1), pod_axis)
        mixed = m * w_self + prv * w_nbr + nxt * w_nbr
        out[k] = mixed.unsqueeze(0).expand(x.shape).contiguous() \
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


def _mix_robust(params: Tree, reduce_full: Callable[[Tree], Tree], *,
                mesh=None, full: Optional[Tree] = None) -> Tree:
    """The robust family on a mesh: the gathered broadcast set (reusing
    the round's ``full``), the full-width reducer on every rank, the local
    rows kept. Order statistics are not sums of partials, so there is no
    psum form."""
    if mesh is None:
        return reduce_full(params if full is None else full)
    full = client_all_gather(params, mesh) if full is None else full
    return client_local_rows(reduce_full(full), mesh)


def mix_median(params: Tree, *, mesh=None,
               full: Optional[Tree] = None) -> Tree:
    """:func:`robust_median` as a mix, on one device or a mesh."""
    return _mix_robust(params, robust_median, mesh=mesh, full=full)


def mix_trimmed(params: Tree, trim: int, *, mesh=None,
                full: Optional[Tree] = None) -> Tree:
    """:func:`robust_trimmed` as a mix, on one device or a mesh."""
    return _mix_robust(params, lambda t: robust_trimmed(t, trim), mesh=mesh,
                       full=full)


def mix_geomedian(params: Tree, n_iters: int = 8, *, eps: float = 1e-6,
                  mesh=None, full: Optional[Tree] = None) -> Tree:
    """:func:`robust_geomedian` as a mix, on one device or a mesh."""
    return _mix_robust(params,
                       lambda t: robust_geomedian(t, n_iters, eps=eps),
                       mesh=mesh, full=full)


# ---------------------------------------------------------------------------
# The psum tier (RoundSpec.fast_allreduce): sums of per-rank partials, which
# reassociate fp32 (tolerance tier, the ledger forks)
# ---------------------------------------------------------------------------


def mix_psum(params: Tree, weights: Optional[torch.Tensor] = None, *,
             mesh=None) -> Tree:
    """Rank-1 mix as a sum over the ranks of locally pre-weighted rows:
    every client adopts ``sum_j w_j x_j / sum_j w_j`` (``weights`` None:
    the mean; else the full ``[C]`` vector, |D_i| sizes or a uniform-row
    topology's row, whose local block each rank takes). One model-sized
    all-reduce a leaf, about C/D times less than the gather. Without a
    mesh it is the same sum-then-scale math on one device.

    >>> import torch
    >>> out = mix_psum({"w": torch.tensor([[0.0], [2.0], [4.0]])})
    >>> [float(v) for v in out["w"].ravel()]
    [2.0, 2.0, 2.0]
    """
    n = 1 if mesh is None else mesh.n_shards
    denom = w_local = None
    if weights is not None:
        w_full = weights.to(torch.float32)
        denom = w_full.sum()
        w_local = w_full if mesh is None else _local_block(w_full, mesh)
    out = {}
    for k in sorted(params):
        leaf = params[k]
        x = leaf.to(torch.float32)
        if weights is None:
            part = x.sum(dim=0)
        else:
            part = torch.tensordot(w_local, x, dims=([0], [0]))
        if mesh is not None:
            part = mesh.all_reduce(part)
        agg = part / _f32(x.shape[0] * n) if weights is None \
            else part / denom
        out[k] = agg.unsqueeze(0).expand(x.shape).to(leaf.dtype) \
            .contiguous()
    return out


def mix_psum_dense(params: Tree, W: torch.Tensor,
                   weights: Optional[torch.Tensor] = None, *, mesh=None,
                   use_kernel: bool = False) -> Tree:
    """Any dense ``W`` in the psum tier: rank ``d`` contracts its client
    rows with its column block ``W[:, d L:(d + 1) L]`` into the ``[C,
    ...]`` partial products every output row owes its clients, the
    partials are summed over the ranks and each keeps its rows. O(C)
    models like the gather, but no rank holds the whole client axis. With
    ``use_kernel`` the column-block product is ``mix_rows_flat`` at R = C,
    K = C/D. Without a mesh it is :func:`mix_gather`."""
    if mesh is None:
        return mix_gather(params, W, weights, use_kernel=use_kernel)
    w_cols = _local_block(_reweight_rows(W, weights), mesh, dim=1) \
        .contiguous()
    out = {}
    for k in sorted(params):
        leaf = params[k]
        flat = leaf.to(torch.float32).reshape(leaf.shape[0], -1) \
            .contiguous()
        part = (fedavg_ops.mix_rows_flat(w_cols, flat) if use_kernel
                else torch.matmul(w_cols, flat))
        mine = _local_block(mesh.all_reduce(part), mesh)
        out[k] = mine.reshape(leaf.shape).to(leaf.dtype)
    return out


def client_divergence_psum(params: Tree, mesh=None,
                           model: Optional[ModelBlocks] = None
                           ) -> torch.Tensor:
    """:func:`client_divergence` from summed partials: the column means
    and the final sum of squares are all-reduced, never the client axis
    gathered. The same quantity up to fp32 association. ``model``: each
    client's squares of a split leaf summed over its model blocks."""
    n = 1 if mesh is None else mesh.n_shards
    total = None
    for k in sorted(params):
        x = params[k].to(torch.float32)
        s = x.sum(dim=0)
        if mesh is not None:
            s = mesh.all_reduce(s)
        mean = s / _f32(x.shape[0] * n)
        sq = ((x - mean) ** 2).reshape(x.shape[0], -1).sum(dim=1)
        if model is not None:
            sq = model.sum(k, sq)
        total = sq if total is None else total + sq
    tsum = total.sum()
    if mesh is not None:
        tsum = mesh.all_reduce(tsum)
    return torch.sqrt(tsum / _f32(total.shape[0] * n))
