"""Client-stacked batches for the trainer (``launch/train.py``).

The FL substrate consumes client-stacked batches [C, m, ...]. They are
built on the CPU from a seeded generator and moved to the run's device, so
the same seed gives the same data on the CPU and on the GPU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
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



# salts of a CohortDataSource's streams: its class templates, its eval set,
# and each client's local set
_TEMPLATES, _EVAL, _CLIENT = 0x746D706C, 0x6576616C, 0x636C6E74


def _rng(seed: int, salt: int, *ids: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, salt, *ids]))


class CohortDataSource:
    """Enrolled-population data for the cohort driver
    (``core.rounds.run_blade_fl_cohort``), the JAX package's
    ``CohortDataSource``.

    Each client's fixed local set is a pure function of ``(seed, client
    id)``: shared class templates (drawn once, so the population learns one
    task), a per-client Dirichlet(alpha) label skew and per-client sample
    noise, with the JAX package's ``(noise, template_scale)`` per dataset.
    A set is built on the CPU from a numpy generator of its own, only when
    a round's cohort holds the client, and moved to ``device`` (from pinned
    memory, without a host sync); an LRU cache keeps ``cache_size`` of them
    there. ``cohort_batch`` is the ``(round_idx, cohort_idx) -> [A, m,
    ...]`` callable the driver takes."""

    def __init__(self, seed: int, samples_per_client: int,
                 dirichlet_alpha: float = 0.5, dataset: str = "mnist",
                 image_dim: int = 784, n_classes: int = 10,
                 cache_size: int = 512, device: DeviceLike = "cuda"):
        if samples_per_client < 1:
            raise ValueError("samples_per_client must be >= 1")
        if cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self.noise, template_scale = ((1.3, 0.35) if dataset == "mnist"
                                      else (4.0, 0.3))
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.samples_per_client = samples_per_client
        self.dirichlet_alpha = dirichlet_alpha
        self.n_classes = n_classes
        self.templates = (_rng(seed, _TEMPLATES).standard_normal(
            (n_classes, image_dim), np.float32)
            * np.float32(template_scale))
        self.eval_data = self._draw(_rng(seed, _EVAL), 2048, skew=False)
        self._cache: "OrderedDict[int, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._cache_size = cache_size

    def _draw(self, rng: np.random.Generator, n: int,
              skew: bool = True) -> Dict[str, torch.Tensor]:
        if skew:
            props = rng.dirichlet(np.full(self.n_classes,
                                          self.dirichlet_alpha))
            y = rng.choice(self.n_classes, size=n, p=props / props.sum())
        else:
            y = rng.integers(0, self.n_classes, n)
        x = self.templates[y] + rng.standard_normal(
            (n, self.templates.shape[1]), np.float32) \
            * np.float32(self.noise)
        out = {"x": torch.sigmoid(torch.from_numpy(x)),
               "y": torch.from_numpy(y.astype(np.int64))}
        if self.device.type == "cuda":
            return {k: v.pin_memory().to(self.device, non_blocking=True)
                    for k, v in out.items()}
        return out

    def client_batch(self, client_id: int) -> Dict[str, torch.Tensor]:
        """Client ``client_id``'s fixed local set ``[m, ...]`` on the
        device: deterministic in the id, cached while recently used."""
        cid = int(client_id)
        hit = self._cache.get(cid)
        if hit is not None:
            self._cache.move_to_end(cid)
            return hit
        batch = self._draw(_rng(self.seed, _CLIENT, cid),
                           self.samples_per_client)
        if len(self._cache) >= self._cache_size:
            self._cache.popitem(last=False)
        self._cache[cid] = batch
        return batch

    def cohort_batch(self, round_idx: int, cohort_idx
                     ) -> Dict[str, torch.Tensor]:
        """The ``[A, m, ...]`` stack of a round's cohort (full-batch GD:
        ``round_idx`` is unused, each client trains on its fixed set)."""
        rows = [self.client_batch(i) for i in np.asarray(cohort_idx)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
