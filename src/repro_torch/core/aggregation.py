"""Decentralized model aggregation (paper §3.1 Steps 2+5).

Every client broadcasts its model and every client computes the same
aggregate: the mean over the leading client axis, re-broadcast to every
client slot. On one GPU that is one pass of the hand-written FedAvg kernel
per leaf (``kernels/fedavg``).
"""
from __future__ import annotations

from typing import Dict, Optional

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
