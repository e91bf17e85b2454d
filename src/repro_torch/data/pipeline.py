"""Client-stacked batches for the trainer (``launch/train.py``).

The FL substrate consumes client-stacked batches [C, m, ...]. They are
built on the CPU from a ``torch.Generator`` and moved to the run's device
once, so the same seed gives the same data on the CPU and on the GPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device


class FLDataSource:
    """Fixed per-client local datasets (paper: |D_i| = 512 samples each);
    each round every client does full-batch GD on its local shard."""

    def __init__(self, generator: torch.Generator, n_clients: int,
                 samples_per_client: int, dirichlet_alpha: float = 0.5,
                 dataset: str = "mnist", seed: int = 0,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        n_eval = 2048
        n_total = n_clients * samples_per_client * 2 + n_eval
        maker = (synthetic.mnist_proxy if dataset == "mnist"
                 else synthetic.fashion_proxy)
        # one draw so train and eval share the SAME class templates
        full = maker(generator, n_total)
        self.eval_data = {k: v[-n_eval:].to(dev) for k, v in full.items()}
        self.data = {k: v[:-n_eval] for k, v in full.items()}
        part = synthetic.dirichlet_partition(
            self.data["y"].cpu().numpy(), n_clients, dirichlet_alpha,
            samples_per_client, seed=seed)
        self.client_data = {k: v.to(dev) for k, v in
                            synthetic.client_batches(self.data, part).items()}

    def round_batch(self, k: int) -> Dict[str, torch.Tensor]:
        # full local batch every round (paper does full-batch GD locally)
        return self.client_data

    def static_batch(self) -> Dict[str, torch.Tensor]:
        """The [C, m, ...] batch every round reuses."""
        return self.client_data

