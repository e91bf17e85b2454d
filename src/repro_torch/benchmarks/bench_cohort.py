"""Cohort-sampled population scaling on the port: rounds a second and mix
memory against C_enrolled (the JAX package's ``benchmarks/bench_cohort.py``).

A dense engine's Steps 2+5 mix is a ``[C, C]`` product over a ``[C, ...]``
carry: both priced by the enrolled count. The cohort driver
(``core.rounds.run_blade_fl_cohort``) prices the round by the active
cohort: the device holds the ``[A, ...]`` stack, the intra-cohort mix is
the sparse segment path at O(A deg), and the population lives in the
host-side ``PopulationStore``. A = 64 stays fixed while C_enrolled runs
over {64, 1 000, 10 000}.

Reported per C_enrolled: rounds a second of the cohort driver (host clock,
after one untimed run at the same spec; the last round ends in its
scatter's sync); the analytic peak mix bytes of a dense ``[C_enrolled,
C_enrolled]`` fp32 matrix against the segment path's edge lists (int64 ids,
fp32 weights) and gathered rows; the store's touched clients and bytes.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_cohort [--rounds 6]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.core import rounds, topology
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses

# a tiny substrate: the bench measures the driver and the mix, not
# training, so the model is about 1 KB and a client holds 8 x 16 features
_IN_DIM, _HIDDEN, _SAMPLES = 16, 8, 8
_COHORT = 64
_DEGREE = 5  # ring_neighbors(A, 2) rows: 4 neighbors and the diagonal


def _batch_fn(seed: int):
    """(round_idx, cohort_idx) -> numpy [A, m, ...], each client's data a
    function of its id: nothing of shape [C_enrolled, ...] is built."""
    def fn(round_idx, cohort_idx):
        rngs = [np.random.default_rng([seed, int(i)]) for i in cohort_idx]
        return {"x": np.stack([r.standard_normal((_SAMPLES, _IN_DIM),
                                                 np.float32) for r in rngs]),
                "y": np.stack([r.integers(0, 10, _SAMPLES) for r in rngs])}
    return fn


def bench(n_rounds: int = 6, seed: int = 0, device="cuda",
          enrolled=(64, 1_000, 10_000)) -> dict:
    dev = resolve_device(device)
    params = init_mlp(torch.Generator().manual_seed(seed), in_dim=_IN_DIM,
                      hidden=_HIDDEN)
    pbytes = sum(v.numel() * v.element_size() for v in params.values())
    spec = rounds.RoundSpec(
        n_clients=_COHORT, tau=2, eta=0.05, mine_attempts=32,
        difficulty_bits=2,
        # an explicit edge list: the segment (gather + index_add) mix
        topology=topology.ExplicitSparse(
            neighbors=topology.ring_neighbors(_COHORT, 2)))
    batch_fn = _batch_fn(seed + 3)
    results = {}
    print(f"{'C_enrolled':>10} {'rounds/s':>9} {'dense_mix_MB':>12} "
          f"{'segment_mix_KB':>14} {'touched':>7} {'store_KB':>8}")
    for c_enrolled in enrolled:
        cohort = topology.CohortSchedule(n_enrolled=c_enrolled,
                                         cohort_size=_COHORT)
        # one untimed round at this spec (first launches, allocator)
        rounds.run_blade_fl_cohort(mlp_client_losses, spec, params,
                                   batch_fn, 1, cohort, seed=seed + 2,
                                   device=dev)
        t0 = time.perf_counter()
        store, hist, ledger = rounds.run_blade_fl_cohort(
            mlp_client_losses, spec, params, batch_fn, n_rounds, cohort,
            seed=seed + 2, device=dev)
        wall = time.perf_counter() - t0
        if not ledger.validate_chain():
            raise RuntimeError(f"chain invalid at C_enrolled={c_enrolled}")
        dense_mix = 4 * c_enrolled * c_enrolled
        segment_mix = _COHORT * _DEGREE * (12 + pbytes)
        rps = n_rounds / wall
        results[f"C{c_enrolled}"] = {
            "n_enrolled": c_enrolled, "cohort": _COHORT,
            "rounds_per_s": rps, "dense_mix_bytes": dense_mix,
            "segment_mix_bytes": segment_mix, "touched": store.touched,
            "store_bytes": store.materialized_bytes(),
            "final_local_loss": hist[-1]["local_loss_mean"],
            "chain_valid": ledger.validate_chain(), "device": str(dev),
        }
        print(f"{c_enrolled:>10} {rps:>9.2f} {dense_mix / 1e6:>12.2f} "
              f"{segment_mix / 1e3:>14.1f} {store.touched:>7} "
              f"{store.materialized_bytes() / 1e3:>8.1f}")
        common.csv_line(
            f"cohort_C{c_enrolled}_A{_COHORT}", 1e6 * wall / n_rounds,
            f"rounds_per_s={rps:.2f},dense_mix_mb={dense_mix / 1e6:.2f},"
            f"segment_mix_kb={segment_mix / 1e3:.1f},"
            f"touched={store.touched}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--enrolled", type=int, nargs="+",
                    default=[64, 1_000, 10_000])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    return bench(a.rounds, a.seed, a.device, a.enrolled)


if __name__ == "__main__":
    main()
