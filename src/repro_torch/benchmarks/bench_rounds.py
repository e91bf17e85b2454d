"""Round throughput on the card: the port's loop driver (the round step in
a Python loop, ``jit=False``) against its graph driver (a warm round, then
CUDA-graph replays: ``rounds.run_blade_fl_scan``), the JAX package's
``benchmarks/bench_rounds.py`` comparison of its per-round loop and its
``lax.scan`` engine.

Two configurations, both C = 20: the JAX package's bench (128 samples a
client, tau 4, 2 lazy clients at sigma2 0.01, 256 mining attempts,
difficulty 2) and the paper's path (512 samples, tau 10, 2 lazy clients,
10 240 attempts, difficulty 4; ``launch/train.py`` defaults). Each run is
timed on the host clock from a synchronize to its one host transfer;
after one untimed run of each, ``reps`` runs a driver alternate which
goes first. Prints one CSV line a driver and configuration
(``name,us_per_round,derived``), then one JSON line with every reading,
the graph driver's capture seconds and the card's name.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_rounds [--rounds 32]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.core import rounds
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses

# name -> (samples a client, tau, mining attempts, difficulty bits)
CONFIGS = {"bench": (128, 4, 256, 2), "paper": (512, 10, 10240, 4)}


def setup(config: str, n_clients: int = 20, device="cuda"):
    """(spec, initial params, static batch) of a configuration, drawn on
    the CPU from seed 0 and moved to ``device``."""
    samples, tau, attempts, bits = CONFIGS[config]
    gen = torch.Generator(device="cpu").manual_seed(0)
    src = FLDataSource(gen, n_clients, samples, seed=0, device=device)
    params = init_mlp(gen)
    spec = rounds.RoundSpec(n_clients=n_clients, tau=tau, eta=0.05,
                            n_lazy=2, sigma2=0.01, mine_attempts=attempts,
                            difficulty_bits=bits)
    return spec, params, src.static_batch()


def bench(config: str, n_rounds: int = 32, n_clients: int = 20,
          reps: int = 3, device="cuda") -> dict:
    """Host ms per round of each driver over ``reps`` warm runs."""
    dev = resolve_device(device)
    spec, params, batch = setup(config, n_clients, dev)

    def run(jit):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, _, ledger = rounds.run_blade_fl(mlp_client_losses, spec, params,
                                           batch, n_rounds, seed=2,
                                           device=dev, jit=jit)
        wall = time.perf_counter() - t0
        if not ledger.validate_chain():
            raise RuntimeError(f"invalid ledger on {config}, jit={jit}")
        return 1e3 * wall / n_rounds

    drivers = {"loop": False, "graph": True}
    ms = {name: [] for name in drivers}
    capture = []
    for name, jit in drivers.items():
        run(jit)   # warm: builds, cuBLAS handles, autograd
    for rep in range(reps):
        order = list(drivers) if rep % 2 == 0 else list(drivers)[::-1]
        for name in order:
            ms[name].append(run(drivers[name]))
            if name == "graph":
                capture.append(rounds.LAST_GRAPH["capture_s"])
    out = {"config": config, "n_rounds": n_rounds, "n_clients": n_clients,
           "ms_per_round": ms, "capture_s": capture}
    for name, readings in ms.items():
        med = statistics.median(readings)
        common.csv_line(f"rounds_{name}_{config}_K{n_rounds}_C{n_clients}",
                        1e3 * med, f"rounds_per_s={1e3 / med:.1f}")
    out["speedup"] = (statistics.median(ms["loop"])
                      / statistics.median(ms["graph"]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", nargs="+", choices=sorted(CONFIGS),
                    default=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = {"device": torch.cuda.get_device_name(resolve_device(a.device)),
           "runs": [bench(c, a.rounds, a.clients, a.reps, a.device)
                    for c in a.configs]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
