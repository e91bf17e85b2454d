"""Lazy-client model (paper §5.1, eq. 7).

A lazy client skips local training, plagiarizes an honest client's freshly
trained model and adds N(0, sigma^2) noise to disguise itself. The lazy set
is static per experiment (first M of N clients); lazy client i copies honest
client M + (i mod (N - M)).

Noise comes from a ``torch.Generator`` on the CPU, so a run draws the same
numbers whichever device it computes on. A run draws all its rounds'
noise before the first (``rounds.draw_noise``, in the order this stage
and ``dp.privatize`` draw it) and passes each round's as ``noise``; tests
may instead pass the JAX package's per-leaf standard-normal draws.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def plagiarism_sources(n_clients: int, n_lazy: int) -> np.ndarray:
    """source[i] = client whose weights client i ends up holding."""
    if not (0 <= n_lazy < n_clients or (n_lazy == n_clients == 0)):
        raise ValueError(
            f"n_lazy={n_lazy}, n_clients={n_clients}: need at least one "
            "honest client when anyone is lazy")
    src = np.arange(n_clients)
    n_honest = n_clients - n_lazy
    for i in range(n_lazy):
        src[i] = n_lazy + (i % n_honest)
    return src


def standard_normal(shape, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """N(0, 1) float32 draws from a CPU generator, moved to ``device``
    without waiting on it (pinned staging when the device is a GPU)."""
    z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    if device.type == "cpu":
        return z
    return z.pin_memory().to(device, non_blocking=True)


def apply_lazy(params: Tree, n_clients: int, n_lazy: int, sigma2: float,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Tree] = None) -> Tree:
    """params: dict of ``[C, ...]`` leaves. Lazy clients (rows < n_lazy)
    take their source's row plus ``sqrt(sigma2) * z``; honest rows are
    untouched. ``z`` is ``noise[k][:n_lazy]`` when given (leaf-shaped
    standard normals), else drawn from ``generator``."""
    if n_lazy == 0:
        return params
    plagiarism_sources(n_clients, n_lazy)   # validates the counts
    std = float(np.sqrt(sigma2))
    out = {}
    for k in sorted(params):
        leaf = params[k]
        # plagiarism_sources' rows for the lazy clients, made on the device
        src = torch.arange(n_lazy, device=leaf.device) % (n_clients - n_lazy)
        stolen = leaf[src + n_lazy]
        if std > 0.0:
            if noise is not None:
                z = noise[k][:n_lazy].to(leaf.device, torch.float32)
            else:
                z = standard_normal(stolen.shape, generator, leaf.device)
            stolen = stolen + (z * std).to(leaf.dtype)
        out[k] = torch.cat([stolen, leaf[n_lazy:]], dim=0)
    return out


def measure_theta(honest_params: Tree, lazy_params: Tree) -> torch.Tensor:
    """theta = ||w_lazy - w_honest||_2 (Theorem 4's degradation term)."""
    total = sum(((lazy_params[k].float() - honest_params[k].float()) ** 2).sum()
                for k in sorted(honest_params))
    return torch.sqrt(total)
