"""Shared experiment runner of the paper-table benchmarks, on the port (§7
substrate: MLP on the synthetic non-IID MNIST / Fashion proxies, N clients,
BLADE-FL rounds). The JAX package's ``benchmarks/common.py`` under the same
names.

Time is normalized by alpha, like the paper: t_sum = 100, beta default 10.
Data and the initial model are drawn as the trainer draws them
(``launch/train.py::prepare_mlp``): the data from a CPU
``torch.Generator`` seeded with ``seed``, then the model from the same
generator, and the run's noise from ``seed + 2``. A static batch on the
card runs on the graph driver (``rounds.run_blade_fl``).

  PYTHONPATH=src python -m repro_torch.benchmarks.paper_tables
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import allocation, bounds, rounds
from repro_torch.core.aggregation import aggregate_once
from repro_torch.core.topology import FullMesh, Topology
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss

Tree = Dict[str, torch.Tensor]

# Single source of truth for the dataset-shaping defaults, shared by
# build_source / run_once / sweep_k so a prebuilt src can never silently
# drift from what run_once would have built itself.
DATA_DEFAULTS = dict(n_clients=20, samples=256, dataset="mnist", seed=0,
                     dirichlet_alpha=0.2)


def build_experiment(device: DeviceLike = "cuda", **kw
                     ) -> Tuple[FLDataSource, Tree]:
    """The FLDataSource and the initial MLP ``run_once`` draws from the
    DATA_DEFAULTS keys in ``kw``, as the trainer draws them: one CPU
    generator seeded with ``seed`` gives the data, then the model."""
    cfg = {**DATA_DEFAULTS, **kw}
    gen = torch.Generator(device="cpu").manual_seed(int(cfg["seed"]))
    src = FLDataSource(gen, cfg["n_clients"], cfg["samples"],
                       cfg["dirichlet_alpha"], dataset=cfg["dataset"],
                       seed=cfg["seed"], device=device)
    return src, init_mlp(gen)


def build_source(device: DeviceLike = "cuda", **kw) -> FLDataSource:
    """The FLDataSource ``run_once`` derives from the same kwargs, so
    sweeps build it once for every K (a pure function of these arguments).
    Accepts the DATA_DEFAULTS keys."""
    return build_experiment(device, **kw)[0]


def _last_finite(curve: List[float]) -> float:
    """Last finite entry of a possibly NaN-masked (eval_every > 1) curve."""
    for v in reversed(curve):
        if math.isfinite(v):
            return v
    return float("nan")


def run_once(*, k: int, t_sum: float = 100.0, alpha: float = 1.0,
             beta: float = 10.0, eta: float = 0.05,
             n_clients: int = DATA_DEFAULTS["n_clients"],
             n_lazy: int = 0, sigma2: float = 0.0, dp_sigma: float = 0.0,
             samples: int = DATA_DEFAULTS["samples"],
             dataset: str = DATA_DEFAULTS["dataset"],
             seed: int = DATA_DEFAULTS["seed"],
             dirichlet_alpha: float = DATA_DEFAULTS["dirichlet_alpha"],
             eval_every: int = 1,
             topology: Optional[Topology] = None,
             src: Optional[FLDataSource] = None,
             params: Optional[Tree] = None,
             device: DeviceLike = "cuda", jit: bool = True
             ) -> Optional[Dict]:
    """One BLADE-FL run at a given K. Returns None when K is infeasible.

    Dir(0.2) heterogeneity: strong enough non-IID that aggregation matters
    and the loss-vs-K curve has the paper's interior optimum. Pass ``src``
    and ``params`` to reuse a prebuilt source and initial model (sweeps;
    any object with ``static_batch()`` and ``eval_data`` serves),
    ``topology`` to run Steps 2+5 over a non-full-mesh mixing matrix,
    ``eval_every`` to stride the global-loss eval, ``jit=False`` to run the
    rounds in the loop driver. ``wall_s`` is the host clock around
    ``rounds.run_blade_fl``, which ends in its one host transfer."""
    tau = allocation.tau_from_budget(t_sum, k, alpha, beta)
    if tau < 1:
        return None
    dev = resolve_device(device)
    if src is None or params is None:
        drawn_src, drawn_params = build_experiment(
            dev, n_clients=n_clients, samples=samples, dataset=dataset,
            seed=seed, dirichlet_alpha=dirichlet_alpha)
        src = drawn_src if src is None else src
        params = drawn_params if params is None else params
    spec = rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=eta, n_lazy=n_lazy, sigma2=sigma2,
        dp_sigma=dp_sigma, mine_attempts=max(int(beta * 16), 8),
        difficulty_bits=2, eval_every=eval_every,
        topology=topology if topology is not None else FullMesh())
    t0 = time.perf_counter()
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.static_batch(), k,
        seed=seed + 2, device=dev, jit=jit)
    wall = time.perf_counter() - t0
    final = aggregate_once(state.params)
    with torch.no_grad():
        eval_loss, m = mlp_loss(final, src.eval_data)
    return {
        "k": k, "tau": tau,
        "train_time": k * tau * alpha, "mine_time": k * beta,
        "final_loss": _last_finite([h["global_loss"] for h in hist]),
        "eval_loss": float(eval_loss), "accuracy": float(m["accuracy"]),
        "loss_curve": [h["global_loss"] for h in hist],
        "divergence": float(hist[-1]["divergence"]),
        "chain_valid": ledger.validate_chain(),
        "driver": rounds.LAST_DISPATCH["driver"],
        "wall_s": wall, "us_per_round": wall / k * 1e6,
    }


def default_ks(t_sum: float = 100.0, alpha: float = 1.0,
               beta: float = 10.0) -> List[int]:
    """The JAX package's sweep: K in {1..6, 8} and the largest feasible
    K, t_sum / (alpha + beta)."""
    kmax = int(t_sum / (alpha + beta))
    return [k for k in sorted({1, 2, 3, 4, 5, 6, 8, kmax}) if 1 <= k <= kmax]


def sweep_k(ks=None, **kw) -> List[Dict]:
    """``run_once`` at each K of ``ks`` (default :func:`default_ks`), with
    the source and the initial model built once for the sweep; infeasible
    Ks are left out."""
    if ks is None:
        ks = default_ks(kw.get("t_sum", 100.0), kw.get("alpha", 1.0),
                        kw.get("beta", 10.0))
    dev = resolve_device(kw.pop("device", "cuda"))
    t0 = time.perf_counter()
    src, params = kw.pop("src", None), kw.pop("params", None)
    if src is None or params is None:
        drawn_src, drawn_params = build_experiment(
            dev, **{key: kw[key] for key in DATA_DEFAULTS if key in kw})
        src = drawn_src if src is None else src
        params = drawn_params if params is None else params
    build_s = time.perf_counter() - t0
    out = []
    for k in ks:
        r = run_once(k=k, src=src, params=params, device=dev, **kw)
        if r is not None:
            out.append(r)
    # one build amortized over the sweep; saved_s counts only the rebuilds
    # actually avoided
    for r in out:
        r["data_build_s"] = build_s
        r["data_build_saved_s"] = build_s * max(len(out) - 1, 0)
    return out


def best_of(results: List[Dict], key: str = "final_loss") -> Dict:
    return min(results, key=lambda r: r[key])


def fit_bound_params(results: List[Dict], *, eta: float, alpha: float,
                     beta: float, t_sum: float) -> bounds.BoundParams:
    """Calibrate (L, xi, delta) empirically and pin the one free scale
    constant w0_dist = ||w0 - w*|| so the bound dominates the empirical
    loss-vs-K curve with minimum slack (§7.2, Fig. 3 protocol).

    With the Appendix-C choice eps^2 = delta*xi/phi the bound is exactly
    LINEAR in w0_dist (g scales as 1/w0), so the tightest dominating scale
    is w0 = max_k empirical(k) / bound_{w0=1}(k).
    """
    curve = results[0]["loss_curve"] if results else [1.0]
    # eval_every > 1 NaN-masks skipped rounds; calibrate on the evaluated ones
    curve = [v for v in curve if math.isfinite(v)] or [1.0]
    c = bounds.estimate_constants(curve)
    p1 = bounds.BoundParams(eta=eta, L=min(c["L"], 0.5 / eta), xi=c["xi"],
                            delta=c["delta"], alpha=alpha, beta=beta,
                            t_sum=t_sum, w0_dist=1.0)
    ratios = []
    for r in results:
        b1 = bounds.loss_bound(p1, r["k"])
        if math.isfinite(b1) and b1 > 0:
            ratios.append(r["final_loss"] / b1)
    w0 = max(ratios) * 1.001 if ratios else 1.0
    return bounds.BoundParams(eta=p1.eta, L=p1.L, xi=p1.xi, delta=p1.delta,
                              alpha=alpha, beta=beta, t_sum=t_sum,
                              w0_dist=w0)


def csv_line(name: str, us_per_call: float, derived: str) -> str:
    line = f"{name},{us_per_call:.1f},{derived}"
    print(line, flush=True)
    return line
