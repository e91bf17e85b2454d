"""Lazy-client detection (beyond the paper: its §8 leaves it as future
work).

A lazy client's broadcast is an honest model plus N(0, sigma^2) noise (eq.
7), so its distance to its source is about ``sigma * sqrt(P)``, far below
the distance between two independently trained non-IID clients. Pairs
closer than a fraction of the median pairwise distance are flagged; so are
updates whose norm is an outlier (the noise is large). Distances are taken
on a random projection of the flattened models, O(C^2 * sketch).

The JAX package draws the projection from ``jax.random.key(seed)``, which
torch cannot reproduce: here it is an injectable ``[F, sketch_dim]``
tensor, else drawn from a CPU ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.aggregation import median0
from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, torch.Tensor]


def sketch_projection(n_features: int, sketch_dim: int = 256,
                      seed: int = 0, device: DeviceLike = "cuda"
                      ) -> torch.Tensor:
    """The ``[F, sketch_dim]`` projection, N(0, 1 / F) entries, drawn on the
    CPU from ``seed`` and moved to ``device`` (the card unless asked for the
    CPU; raises without a GPU)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    proj = torch.randn((n_features, sketch_dim), generator=gen,
                       dtype=torch.float32) * (n_features ** -0.5)
    return proj.to(device)


def _flatten(params: Tree) -> torch.Tensor:
    """``[C, F]``: every client's leaves in sorted key order."""
    return torch.cat([params[k].reshape(params[k].shape[0], -1)
                      .to(torch.float32) for k in sorted(params)], dim=1)


def model_sketches(params: Tree, projection: torch.Tensor) -> torch.Tensor:
    """``[C, sketch_dim]`` random-projection sketch of each client's
    model; ``projection`` is ``[F, sketch_dim]``."""
    flat = _flatten(params)
    if projection.shape[0] != flat.shape[1]:
        raise ValueError(f"projection has {projection.shape[0]} rows, the "
                         f"models {flat.shape[1]} features")
    return flat @ projection


def pairwise_distances(sketches: torch.Tensor) -> torch.Tensor:
    """[C, C] Euclidean distances between client sketches."""
    sq = (sketches ** 2).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2 * sketches @ sketches.T
    return torch.sqrt(torch.clamp(d2, min=0.0))


def detect_lazy(params: Tree, projection: torch.Tensor, *,
                threshold_frac: float = 0.2
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (suspect_mask [C] bool, min_dist_frac [C]): a client is
    flagged when its nearest-neighbour distance is below ``threshold_frac``
    times the median pairwise distance. Both members of a plagiarism pair
    are flagged."""
    d = pairwise_distances(model_sketches(params, projection))
    c = d.shape[0]
    big = d.max() + 1.0
    d_offdiag = d + torch.eye(c, device=d.device) * big
    nearest = d_offdiag.min(dim=1).values
    iu = torch.triu_indices(c, c, offset=1, device=d.device)
    median = median0(d_offdiag[iu[0], iu[1]])
    frac = nearest / torch.clamp(median, min=1e-12)
    return frac < threshold_frac, frac


def detect_lazy_round(params: Tree, params_ref: Tree,
                      projection: torch.Tensor, *,
                      threshold_frac: float = 0.2,
                      norm_factor: float = 3.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-sided in-round detector: the nearest-neighbour test
    (:func:`detect_lazy`) or-ed with an update-norm outlier test against
    ``params_ref``, the models every client started the round from (one
    model, or client-stacked). Returns (suspect_mask, update_norms)."""
    near_mask, _ = detect_lazy(params, projection,
                               threshold_frac=threshold_frac)
    delta = {}
    for k, a in params.items():
        r = params_ref[k]
        r = r.unsqueeze(0) if r.dim() + 1 == a.dim() else r
        delta[k] = a - r.expand(a.shape).to(a.dtype)
    sk = model_sketches(delta, projection)
    norms = torch.sqrt((sk ** 2).sum(dim=1))
    median = median0(norms)
    outlier_mask = norms > norm_factor * torch.clamp(median, min=1e-12)
    return near_mask | outlier_mask, norms


def detection_metrics(suspect_mask: torch.Tensor, n_lazy: int) -> dict:
    """Precision / recall against the first ``n_lazy`` clients; with
    nothing flagged precision is 1.0, with ``n_lazy == 0`` recall is 1.0."""
    c = suspect_mask.shape[0]
    truth = torch.arange(c, device=suspect_mask.device) < n_lazy
    tp = int((suspect_mask & truth).sum())
    fp = int((suspect_mask & ~truth).sum())
    fn = int((~suspect_mask & truth).sum())
    return {
        "precision": tp / (tp + fp) if tp + fp else 1.0,
        "recall": tp / (tp + fn) if tp + fn else 1.0,
        "flagged": tp + fp,
    }

