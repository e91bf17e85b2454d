"""Attack x defense sweep on the port: what each robust aggregator buys
under each Byzantine attack, and what it costs (the JAX package's
``benchmarks/bench_robust.py``).

Grid: the attack zoo (``core/attacks.py``) crossed with the linear mean and
the three robust reducers (``RoundSpec.robust_agg``). Each cell is a whole
BLADE-FL run; the table reports the held-out loss and accuracy of the final
aggregate, the loss gap against the clean run under the same aggregator,
and the host time a round. A second sweep scales the sign-flip attack: the
linear mean degrades with its scale, the trimmed mean stays bounded by the
honest envelope. ``models_moved_per_device_4way`` is the price of a
robust reducer on a 4-way client-sharded mesh: the models each rank
receives a round for the gathered order statistics
(``plans.gathered_mix_models_moved``), where the psum tier of a linear
mix moves one.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_robust [--samples 64]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.core import attacks, rounds
from repro_torch.core.aggregation import aggregate_once
from repro_torch.models.mlp import mlp_client_losses, mlp_loss
from repro_torch.sharding import plans

ATTACKS = (
    ("clean", None),
    ("signflip2", attacks.SignFlip(n_attackers=3, scale=2.0)),
    ("alie", attacks.ALIE(n_attackers=3, z=1.5)),
    ("replace", attacks.ModelReplacement(n_attackers=1)),
)

AGGREGATORS = ("mean", "median", "trimmed:3", "geomed:8")


def _run_cell(src, params, *, n_clients, k, tau, atk, robust, seed, device):
    spec = rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=0.05, mine_attempts=32,
        difficulty_bits=2, attack=atk,
        robust_agg=None if robust == "mean" else robust)
    t0 = time.perf_counter()
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.static_batch(), k,
        seed=seed + 2, device=device)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        eval_loss, m = mlp_loss(aggregate_once(state.params), src.eval_data)
    return {
        "eval_loss": float(eval_loss), "accuracy": float(m["accuracy"]),
        "final_loss": hist[-1]["global_loss"],
        "chain_valid": ledger.validate_chain(),
        "wall_s": wall, "us_per_round": wall / k * 1e6,
    }


def bench(samples: int = 64, n_clients: int = 16, k: int = 6, tau: int = 2,
          seed: int = 0, device="cuda") -> dict:
    src, params = common.build_experiment(device, n_clients=n_clients,
                                          samples=samples, seed=seed)
    cell = dict(n_clients=n_clients, k=k, tau=tau, seed=seed, device=device)
    # the gathered-mix price every robust aggregator pays on a 4-way mesh
    results = {"models_moved_per_device_4way":
               plans.gathered_mix_models_moved(n_clients, 4)}
    print(f"{'attack':>10} {'aggregator':>10} {'eval_loss':>9} "
          f"{'accuracy':>8} {'loss_gap':>9} {'us_per_round':>12}")
    for agg in AGGREGATORS:
        clean = None
        for atk_name, atk in ATTACKS:
            row = _run_cell(src, params, atk=atk, robust=agg, **cell)
            if atk_name == "clean":
                clean = row["eval_loss"]
            row["loss_gap_vs_clean"] = row["eval_loss"] - clean
            results[f"{agg}|{atk_name}"] = row
            print(f"{atk_name:>10} {agg:>10} {row['eval_loss']:>9.4f} "
                  f"{row['accuracy']:>8.3f} "
                  f"{row['loss_gap_vs_clean']:>9.4f} "
                  f"{row['us_per_round']:>12.0f}")
            common.csv_line(
                f"robust_{agg.replace(':', '_')}_{atk_name}",
                row["us_per_round"],
                f"eval_loss={row['eval_loss']:.4f} "
                f"gap={row['loss_gap_vs_clean']:.4f}")
    # the breakdown: loss against sign-flip scale, mean against trimmed
    strength = {}
    for scale in (1.0, 4.0, 16.0):
        atk = attacks.SignFlip(n_attackers=3, scale=scale)
        for agg in ("mean", "trimmed:3"):
            row = _run_cell(src, params, atk=atk, robust=agg, **cell)
            strength[f"{agg}|scale{scale:g}"] = row["eval_loss"]
            common.csv_line(
                f"robust_strength_{agg.replace(':', '_')}_s{scale:g}",
                row["us_per_round"], f"eval_loss={row['eval_loss']:.4f}")
    results["signflip_strength_sweep"] = strength
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    return bench(samples=a.samples, n_clients=a.clients, k=a.k, seed=a.seed,
                 device=a.device)


if __name__ == "__main__":
    main()
