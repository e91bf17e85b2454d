"""Loss against K under time-varying topology schedules, with spectral-gap
diagnostics, on the port (the JAX package's
``benchmarks/bench_schedules.py``).

Schedules make the Steps 2+5 mixing matrix a function of the round: a
one-peer gossip rotation, ring epochs with a full-mesh sync round, SNR
link-quality weighting. The spectral gap ``1 - |lambda_2(W)|``
(``core.spectral``) says how fast client disagreement contracts a round;
for a schedule the ergodic gap of the product matrix is the honest rate.
Per schedule:

  * the loss-against-K sweep and its best K (``common.sweep_k``);
  * the ergodic gap and the predicted contraction ``1 - gap``;
  * the observed contraction: the geometric decay rate of the run's
    per-round divergence at a fixed K.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_schedules [--samples 128]
"""
from __future__ import annotations

import argparse
import math

from repro_torch.benchmarks import common
from repro_torch.core import rounds, spectral, topology
from repro_torch.models.mlp import mlp_client_losses


def schedules(n_clients: int):
    return (
        ("full_mesh", topology.FullMesh()),
        ("ring1", topology.Ring(neighbors=1)),
        ("rotate", topology.GossipRotation()),
        ("alt_ring3_mesh1", topology.AlternatingSchedule(
            ((topology.Ring(neighbors=1), 3), (topology.FullMesh(), 1)))),
        ("snr_fade8", topology.LinkQualitySchedule(fading_period=8)),
        # the ring-2 graph as an explicit edge list: the segment mix in the
        # round, the densified edge list in the spectral diagnostics
        ("sparse_ring2", topology.ExplicitSparse(
            neighbors=topology.ring_neighbors(n_clients, 2))),
    )


def observed_consensus_rate(topo, *, n_clients: int, samples: int, k: int,
                            seed: int, device="cuda") -> float:
    """Geometric per-round decay of the run's divergence metric over a
    fixed-K run, ``(div_K / div_1) ** (1 / (K - 1))`` (1.0: no
    contraction). Compare with ``1 - ergodic_gap``."""
    src, params = common.build_experiment(device, n_clients=n_clients,
                                          samples=samples, seed=seed)
    spec = rounds.RoundSpec(n_clients=n_clients, tau=2, eta=0.05,
                            mine_attempts=32, difficulty_bits=2,
                            topology=topo)
    _, hist, _ = rounds.run_blade_fl(mlp_client_losses, spec, params,
                                     src.static_batch(), k, seed=seed + 2,
                                     device=device)
    divs = [h["divergence"] for h in hist]
    if len(divs) < 2 or divs[0] <= 0 or \
            not all(math.isfinite(d) for d in divs):
        return float("nan")
    return (max(divs[-1], 1e-12) / divs[0]) ** (1.0 / (len(divs) - 1))


def bench(samples: int = 128, n_clients: int = 20, beta: float = 6.0,
          seed: int = 0, rate_k: int = 10, t_sum: float = 100.0,
          device="cuda") -> dict:
    results = {}
    print(f"{'schedule':>16} {'K*':>3} {'eval_loss':>9} {'accuracy':>8} "
          f"{'erg_gap':>8} {'pred_rate':>9} {'obs_rate':>8}")
    for name, topo in schedules(n_clients):
        res = common.sweep_k(n_clients=n_clients, samples=samples, beta=beta,
                             seed=seed, t_sum=t_sum, topology=topo,
                             device=device)
        best = common.best_of(res, key="eval_loss")
        gap = spectral.ergodic_gap(topo, n_clients, n_rounds=rate_k)
        obs = observed_consensus_rate(topo, n_clients=n_clients,
                                      samples=samples, k=rate_k, seed=seed,
                                      device=device)
        results[name] = {
            "best_k": best["k"], "eval_loss": best["eval_loss"],
            "accuracy": best["accuracy"],
            "eval_loss_vs_k": {r["k"]: r["eval_loss"] for r in res},
            "ergodic_gap": gap, "predicted_consensus_rate": 1.0 - gap,
            "observed_consensus_rate": obs,
            "chain_valid": all(r["chain_valid"] for r in res),
        }
        print(f"{name:>16} {best['k']:>3} {best['eval_loss']:>9.4f} "
              f"{best['accuracy']:>8.3f} {gap:>8.4f} {1.0 - gap:>9.4f} "
              f"{obs:>8.4f}")
        common.csv_line(
            f"schedule_{name}_C{n_clients}", best["us_per_round"],
            f"best_k={best['k']},eval_loss={best['eval_loss']:.4f},"
            f"ergodic_gap={gap:.4f}")
    # schedules ordered by gap should order by observed contraction
    ordered = sorted(results.items(), key=lambda kv: -kv[1]["ergodic_gap"])
    results["_gap_rate_ranking"] = [
        {"schedule": n, "ergodic_gap": r["ergodic_gap"],
         "observed_consensus_rate": r["observed_consensus_rate"]}
        for n, r in ordered]
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--beta", type=float, default=6.0)
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate-k", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    return bench(a.samples, a.clients, a.beta, a.seed, a.rate_k, a.t_sum,
                 a.device)


if __name__ == "__main__":
    main()
