"""Synthetic datasets (no downloads).

``mnist_proxy``: class-conditional Gaussian images with the MNIST interface
(28x28 grayscale, 10 classes). Each class has a fixed random template;
samples are template + noise, squashed to (0, 1), so the task is learnable
and the loss curves decrease non-trivially.

``dirichlet_partition``: non-IID label split across N clients (Dir(alpha)).
It is seeded with numpy, so it gives the JAX package's partition exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def mnist_proxy(generator: torch.Generator, n_samples: int,
                n_classes: int = 10, image_dim: int = 784,
                noise: float = 1.3, template_scale: float = 0.35
                ) -> Dict[str, torch.Tensor]:
    """Returns {"x": [n, image_dim] float32 in (0, 1), "y": [n] int64},
    drawn on the generator's device."""
    dev = generator.device
    templates = torch.randn((n_classes, image_dim), generator=generator,
                            device=dev) * template_scale
    y = torch.randint(0, n_classes, (n_samples,), generator=generator,
                      device=dev)
    x = templates[y] + torch.randn((n_samples, image_dim),
                                   generator=generator, device=dev) * noise
    return {"x": torch.sigmoid(x).to(torch.float32), "y": y}


def fashion_proxy(generator: torch.Generator, n_samples: int, **kw
                  ) -> Dict[str, torch.Tensor]:
    """Fashion-MNIST stand-in: same interface, harder (noisier) templates."""
    kw.setdefault("noise", 4.0)
    kw.setdefault("template_scale", 0.3)
    return mnist_proxy(generator, n_samples, **kw)


def dirichlet_partition(y: np.ndarray, n_clients: int, alpha: float,
                        samples_per_client: int, seed: int = 0) -> np.ndarray:
    """Non-IID split: client i draws labels with proportions ~ Dir(alpha).

    Returns index array [n_clients, samples_per_client] into the dataset.
    """
    rng = np.random.default_rng(seed)
    y = np.asarray(y)
    n_classes = int(y.max()) + 1
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    out = np.zeros((n_clients, samples_per_client), dtype=np.int64)
    for i in range(n_clients):
        props = rng.dirichlet(np.full(n_classes, alpha))
        counts = rng.multinomial(samples_per_client, props)
        chosen = []
        for c, k in enumerate(counts):
            pool = by_class[c]
            take = rng.choice(pool, size=k, replace=len(pool) < k)
            chosen.append(take)
        flat = np.concatenate(chosen)
        rng.shuffle(flat)
        out[i] = flat[:samples_per_client]
    return out


def client_batches(data: Dict[str, torch.Tensor], partition: np.ndarray
                   ) -> Dict[str, torch.Tensor]:
    """Stack per-client shards: {"x": [C, m, d], "y": [C, m]}."""
    out = {}
    for k, v in data.items():
        idx = torch.as_tensor(partition, dtype=torch.int64, device=v.device)
        out[k] = v[idx]
    return out
