"""Differential privacy on broadcast models (paper §6, Definition 2).

Clients add Gaussian noise to the model they broadcast. DP moves the
achievable loss but not the optimal K: privacy and resource allocation
decouple.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.lazy import standard_normal

Tree = Dict[str, torch.Tensor]


def gaussian_sigma(epsilon: float, delta: float, sensitivity: float = 1.0) -> float:
    """Classic Gaussian-mechanism calibration: sigma >= sqrt(2 ln(1.25/delta)) * S / eps."""
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon


def epsilon_of_sigma(sigma: float, delta: float, sensitivity: float = 1.0) -> float:
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / max(sigma, 1e-12)


def privatize(params: Tree, sigma: float,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tree] = None) -> Tree:
    """Add N(0, sigma^2) to every leaf (per client, before the broadcast).
    ``noise`` (leaf-shaped standard normals) replaces the generator's draws
    when given."""
    if sigma <= 0.0:
        return params
    out = {}
    for k in sorted(params):
        leaf = params[k]
        if noise is not None:
            z = noise[k].to(leaf.device, torch.float32)
        else:
            z = standard_normal(leaf.shape, generator, leaf.device)
        out[k] = leaf + (z * sigma).to(leaf.dtype)
    return out
