"""Loss against K under different communication topologies (Steps 2+5),
on the port (the JAX package's ``benchmarks/bench_topology.py``).

The paper's round is a full mesh: every broadcast reaches every client
and all clients adopt the same aggregate. Under the same t_sum budget,
ring gossip and per-round link dropout slow consensus (higher divergence,
worse held-out loss at the same K) and move where the loss-against-K
optimum sits. Each sweep builds its data once (``common.sweep_k``); the
``build_saved_s`` column is the wall time that saves.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_topology [--samples 128]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks import common
from repro_torch.core import topology

TOPOLOGIES = (
    ("full_mesh", topology.FullMesh()),
    ("ring1", topology.Ring(neighbors=1)),
    ("p_dropout_0.5", topology.RandomGraph(p_link=0.5)),
    ("partial_half", None),  # sized per n_clients in bench()
)


def bench(samples: int = 128, n_clients: int = 20, beta: float = 6.0,
          seed: int = 0, t_sum: float = 100.0, device="cuda") -> dict:
    # ranked on eval_loss (held-out data, aggregated model): the train-side
    # final_loss is each client's loss on its own shard, which rewards
    # topologies that do not mix for overfitting locally
    results = {}
    print(f"{'topology':>14} {'K*':>3} {'eval_loss':>9} {'accuracy':>8} "
          f"{'divergence':>10} {'build_saved_s':>13}")
    for name, topo in TOPOLOGIES:
        if topo is None:
            topo = topology.PartialParticipation(
                n_active=max(n_clients // 2, 1))
        res = common.sweep_k(n_clients=n_clients, samples=samples, beta=beta,
                             seed=seed, t_sum=t_sum, topology=topo,
                             device=device)
        best = common.best_of(res, key="eval_loss")
        results[name] = {
            "best_k": best["k"], "eval_loss": best["eval_loss"],
            "accuracy": best["accuracy"], "final_loss": best["final_loss"],
            "divergence": best["divergence"],
            "eval_loss_vs_k": {r["k"]: r["eval_loss"] for r in res},
            "data_build_saved_s": best["data_build_saved_s"],
            "chain_valid": all(r["chain_valid"] for r in res),
        }
        print(f"{name:>14} {best['k']:>3} {best['eval_loss']:>9.4f} "
              f"{best['accuracy']:>8.3f} {best['divergence']:>10.3e} "
              f"{best['data_build_saved_s']:>13.2f}")
        common.csv_line(
            f"topology_{name}_C{n_clients}", best["us_per_round"],
            f"best_k={best['k']},eval_loss={best['eval_loss']:.4f}")
    full = results["full_mesh"]["eval_loss"]
    for r in results.values():
        r["eval_gap_vs_full_mesh"] = r["eval_loss"] - full
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--beta", type=float, default=6.0)
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    return bench(a.samples, a.clients, a.beta, a.seed, a.t_sum, a.device)


if __name__ == "__main__":
    main()
