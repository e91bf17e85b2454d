"""Cohort sampling on the PyTorch/CUDA port: a 5,000-client enrolled
population, a cohort of 8 a round.

``examples/cohort_population.py`` over the port's API. The cohort driver
keeps the paper's integrated round (local training, lazy/DP perturbation,
the mix, the PoW race, the hash-linked ledger) but runs it on a cohort of
A clients a round, drawn from the enrolled population: the device holds
only the ``[A, ...]`` stack, and the population lives in a lazy host-side
store that keeps a client's row only once it has taken part. The
memberships are drawn from the run seed's own stream
(``topology.cohort_table``), so the seed replays which clients were active
in each round. On the GPU by default.

  PYTHONPATH=src python examples/torch_cohort_population.py
  PYTHONPATH=src python examples/torch_cohort_population.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import rounds, topology
from repro_torch.data.pipeline import CohortDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--enrolled", type=int, default=5_000)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--samples", type=int, default=64,
                    help="samples a client")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data = CohortDataSource(0, samples_per_client=args.samples,
                            dirichlet_alpha=0.2, device=dev)
    params = init_mlp(torch.Generator().manual_seed(0))

    # Pareto(1.5) participation weights: a heavy head of frequently-online
    # clients and a long tail that almost never joins
    cohort = topology.CohortSchedule.from_spec(args.enrolled, args.cohort,
                                               "pareto:1.5")
    spec = rounds.RoundSpec(n_clients=args.cohort, tau=4, eta=0.1,
                            mine_attempts=64, difficulty_bits=2,
                            topology=topology.FullMesh())
    seed = 2
    store, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, spec, params, data.cohort_batch, args.rounds,
        cohort, seed=seed, device=dev)

    print(f"{'round':>5} {'cohort (client ids)':>34} {'local_loss':>10}")
    for k, h in enumerate(hist):
        ids = ",".join(str(i) for i in h["cohort"])
        print(f"{k:>5} {ids:>34} {h['local_loss_mean']:>10.4f}")

    # replay check: the run seed reproduces every membership
    replayed = topology.cohort_table(cohort, args.rounds, seed).tolist()
    assert replayed == [h["cohort"] for h in hist]

    print(f"\nenrolled {args.enrolled}, cohort {args.cohort}, "
          f"{args.rounds} rounds on {dev}")
    print(f"clients ever active: {store.touched} "
          f"(host stores {store.materialized_bytes() / 1e6:.1f} MB, "
          f"not {args.enrolled} model copies)")
    print(f"chain valid: {ledger.validate_chain()} "
          f"({len(ledger.blocks)} blocks)")
    print("cohort replay from the seed (topology.cohort_table): exact")
    return store, hist, ledger


if __name__ == "__main__":
    main()
