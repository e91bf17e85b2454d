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
:func:`bench_kernel_path` (the reference's kernel-path tiers, at most 8
rounds) runs after them.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_rounds [--rounds 32]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from repro_torch import kernels
from repro_torch.benchmarks import common, roofline
from repro_torch.core import rounds
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses

# name -> (samples a client, tau, mining attempts, difficulty bits)
CONFIGS = {"bench": (128, 4, 256, 2), "paper": (512, 10, 10240, 4)}


def setup(config: str, n_clients: int = 20, device="cuda"):
    """(spec, initial params, static batch) of a configuration, drawn on
    the CPU from seed 0 and moved to ``device``."""
    return _draw(*CONFIGS[config], n_clients, device)


def _draw(samples, tau, attempts, bits, n_clients, device):
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
        _sync(dev)
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
            if rounds.LAST_DISPATCH["driver"] == "graph":   # not the CPU
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


def bench_kernel_path(n_rounds: int = 8, n_clients: int = 20,
                      samples: int = 128, tau: int = 4, reps: int = 3,
                      mine_attempts: int = 1024, device="cuda") -> dict:
    """Rounds/s of the reference's kernel-path tiers, with the launches of
    each kernel and the analytic hot-block bytes a round
    (``roofline.round_hot_block_bytes``), on the reference's ``_setup``
    configuration (FullMesh, 2 lazy clients, sigma2 0.01, difficulty 2).

    The reference's three tiers choose kernels by ``use_kernel``; the port
    has none (the device decides), so its tiers are the default dispatch
    and ``fused_mix=True``. On FullMesh the plan is the FedAvg mix either
    way (``topology.resolve_mix_plan``), so both tiers run the same
    kernels; their launches are recorded as they come. The byte estimate
    keeps the reference's call (``fused_mix`` the tier's), so the default
    tier's counts a second digest sweep the port does not make (it makes
    the one ``digest_div_flat`` sweep on every path). Each tier runs once
    untimed, then the tiers take turns ``reps`` times (which goes first
    alternates); a tier's time is its runs' mean (each run's seconds in
    ``runs_s``), its launches, dispatch and chain those of its last run.
    """
    dev = resolve_device(device)
    spec, params, batch = _draw(samples, tau, mine_attempts, 2, n_clients,
                                dev)
    model_bytes = sum(v.numel() * v.element_size() for v in params.values())
    tiers = {"default": spec,
             "fused_mix": dataclasses.replace(spec, fused_mix=True)}

    def go(name):
        return rounds.run_blade_fl(mlp_client_losses, tiers[name], params,
                                   batch, n_rounds, seed=2, device=dev)

    for name in tiers:
        go(name)   # warm: builds, cuBLAS handles, autograd
    out, runs = {}, {name: [] for name in tiers}
    for rep in range(reps):
        for name in list(tiers)[::1 if rep % 2 == 0 else -1]:
            kernels.reset_launch_counts()
            _sync(dev)
            t0 = time.perf_counter()
            _, _, ledger = go(name)   # ends in its one host transfer
            runs[name].append(time.perf_counter() - t0)
            out[name] = {"dispatch": dict(rounds.LAST_DISPATCH),
                         "launches": kernels.launch_counts(),
                         "chain_valid": ledger.validate_chain()}
    wall = {name: sum(r) / reps for name, r in runs.items()}
    for name, tier in tiers.items():
        disp = out[name]["dispatch"]
        est = roofline.round_hot_block_bytes(
            model_bytes, n_clients, mine_attempts, fused_mix=tier.fused_mix)
        out[name].update(rounds_per_s=n_rounds / wall[name],
                         wall_s=wall[name], runs_s=runs[name],
                         est_hot_block_bytes_per_round=est["total_bytes"])
        common.csv_line(
            f"rounds_{name}_K{n_rounds}_C{n_clients}",
            wall[name] / n_rounds * 1e6,
            f"rounds_per_s={n_rounds / wall[name]:.1f};"
            f"dispatch={disp['driver']}/{disp['pow']}/{disp['mix']};"
            f"est_bytes_per_round={est['total_bytes']:.3g}")
    out["fused_mix"]["vs_default"] = (out["fused_mix"]["rounds_per_s"]
                                      / out["default"]["rounds_per_s"])
    out["note"] = (f"tiers ran on {_device_name(dev)}; the device picks "
                   "the kernels, so both tiers time the same FedAvg plan "
                   "on FullMesh")
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", nargs="+", choices=sorted(CONFIGS),
                    default=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = {"device": _device_name(resolve_device(a.device)),
           "runs": [bench(c, a.rounds, a.clients, a.reps, a.device)
                    for c in a.configs],
           "kernel_path": bench_kernel_path(min(a.rounds, 8), a.clients,
                                            reps=a.reps, device=a.device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
