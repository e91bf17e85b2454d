"""Paper §7.1 experimental model: MLP with one 256-unit hidden layer + ReLU,
10-class softmax (MNIST / Fashion-MNIST shape).

Params are a dict in the JAX package's layout: ``w1 [784, 256]``,
``b1 [256]``, ``w2 [256, 10]``, ``b2 [10]``; the round stacks them per
client as ``[C, ...]``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers

Tree = Dict[str, torch.Tensor]


def init_mlp(generator: torch.Generator, in_dim: int = 784,
             hidden: int = 256, n_classes: int = 10,
             dtype=torch.float32) -> Tree:
    dev = generator.device
    return {
        "w1": layers.dense_init(generator, in_dim, hidden, dtype),
        "b1": torch.zeros((hidden,), dtype=dtype, device=dev),
        "w2": layers.dense_init(generator, hidden, n_classes, dtype),
        "b2": torch.zeros((n_classes,), dtype=dtype, device=dev),
    }


def mlp_logits(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """One model: x [B, in] -> [B, classes]. Client-stacked params
    ``[C, ...]`` with x [C, B, in] -> [C, B, classes], one ``bmm`` per
    layer."""
    if x.dim() == 3:
        h = torch.relu(torch.bmm(x, params["w1"]) + params["b1"].unsqueeze(1))
        return torch.bmm(h, params["w2"]) + params["b2"].unsqueeze(1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: Tree, batch: Tree) -> Tuple[torch.Tensor, Tree]:
    """One model. batch: {"x": [B, in_dim], "y": [B] int} -> (loss,
    metrics)."""
    logits = mlp_logits(params, batch["x"])
    loss = layers.softmax_cross_entropy(logits, batch["y"])
    acc = (logits.argmax(-1) == batch["y"]).to(torch.float32).mean()
    return loss, {"accuracy": acc}


def mlp_client_losses(params: Tree, batch: Tree) -> torch.Tensor:
    """Client-stacked params and batch ({"x": [C, m, in], "y": [C, m]}) ->
    per-client loss [C]: the JAX package's ``vmap(mlp_loss)``."""
    logits = mlp_logits(params, batch["x"])
    return layers.softmax_cross_entropy(logits, batch["y"])
