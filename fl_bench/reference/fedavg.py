"""One BLADE-FL training job in plain PyTorch: K rounds in which each of C
clients takes tau plain gradient-descent steps on its own tokens from the
shared model, the clients' models are averaged (FedAvg), and the average
is evaluated on every client's tokens.

What a round reports, as the program reports it:
  local_loss   mean over clients of the loss at the last step's starting
               params
  divergence   sqrt(mean over clients of the squared distance of each
               client's trained model from the clients' mean), before the
               average (Definition 1's diagnostic)
  global_loss  mean over clients of the averaged model's loss on that
               client's tokens, on the rounds that evaluate (NaN on the
               others)
  digest       each leaf's (sum, sum of magnitudes) over every client's
               trained rows, in float64: the sums the block header's
               digest folds
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

Weights = Dict[str, torch.Tensor]


def client_steps(w: Weights, widths: Mapping, tokens: torch.Tensor, tau: int,
                 eta: float, loss: Callable):
    """(the client's model after ``tau`` steps, the loss at the last step's
    starting params)."""
    p = {k: v.clone() for k, v in w.items()}
    last = None
    for _ in range(tau):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            value = loss(leaves, widths, tokens)
            grads = torch.autograd.grad(value, list(leaves.values()))
        p = {k: leaves[k].detach() - eta * g
             for k, g in zip(leaves, grads)}
        last = value.detach()
    return p, last


def run_job(w0: Weights, widths: Mapping, batch: torch.Tensor, tau: int,
            eta: float, loss: Callable,
            evals: Optional[Sequence[bool]] = None):
    """Run a job on ``batch`` [K, C, B, S + 1] from ``w0``; ``evals[k]``
    says whether round k computes the global loss (default: every round).
    Returns (per-round ``{"local_loss", "global_loss", "divergence",
    "digest"}`` lists, the final averaged model)."""
    n_rounds, n_clients = batch.shape[0], batch.shape[1]
    evals = [True] * n_rounds if evals is None else list(evals)
    w = {k: v.clone() for k, v in w0.items()}
    out: Dict[str, List] = {"local_loss": [], "global_loss": [],
                            "divergence": [], "digest": []}
    for k in range(n_rounds):
        mean = {n: torch.zeros_like(v) for n, v in w.items()}
        sums = {n: torch.zeros((), dtype=torch.float64, device=v.device)
                for n, v in w.items()}
        mags = {n: torch.zeros_like(s) for n, s in sums.items()}
        trained, losses = [], []
        for c in range(n_clients):
            p, last = client_steps(w, widths, batch[k, c], tau, eta, loss)
            trained.append(p)
            losses.append(float(last))
            for n in mean:
                mean[n] += p[n]
                sums[n] += p[n].sum(dtype=torch.float64)
                mags[n] += p[n].abs().sum(dtype=torch.float64)
        for n in mean:
            mean[n] /= n_clients
        sq = 0.0
        for p in trained:
            for n in mean:
                sq += float((p[n].double() - mean[n].double()).square().sum())
        del trained
        w = mean
        if evals[k]:
            with torch.no_grad():
                glosses = [float(loss(w, widths, batch[k, c]))
                           for c in range(n_clients)]
            out["global_loss"].append(sum(glosses) / n_clients)
        else:
            out["global_loss"].append(float("nan"))
        out["local_loss"].append(sum(losses) / n_clients)
        out["divergence"].append((sq / n_clients) ** 0.5)
        out["digest"].append({n: (float(sums[n]), float(mags[n]))
                              for n in sums})
    return out, w
