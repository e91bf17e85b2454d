"""Rounds a second of the client-sharded engine against the rank count, in
three tiers side by side (the JAX package's ``benchmarks/bench_multidevice
.py``):

  * ``gather`` the default, bitwise tier: the broadcast set all-gathered,
    the full-width math on every rank, each keeping its rows;
  * ``psum``   ``RoundSpec.fast_allreduce``: the mix and the digest /
    divergence sum per-rank partials (one model-sized all-reduce on
    FullMesh), tolerance tier, the ledger forks;
  * ``kernel`` ``RoundSpec.fused_mix``: a dense mix through the
    ``mix_rows_flat`` kernel, each rank computing only its own rows
    (R = C/D, K = C). On FullMesh, the default topology, the mix is the
    FedAvg kernel in both this and the gather tier (the port has one
    diagnostic sweep and always races on the kernel), so the two differ
    only on a dense topology (``--topology random:0.5``).

D = 1 is the plain one-process run; each D > 1 runs in its own world of D
ranks (``launch.mesh.run_world``), all three tiers in it, rank 0 timing.
Beside rounds a second each row gives ``est_mix_bytes_per_round``, the
reference's analytic receive volume of the communicate stage a rank (the
gather: the other ranks' ``C - C/D`` models; the psum: a ring all-reduce
of one model, ``2 (D - 1) / D`` of it), and ``received_bytes_per_round``,
what the mesh counted its collectives receiving (the metrics' gathers and
the perturb stage's too).

Ranks on one GPU run over gloo and share the card, so read their rounds a
second as the cost of the sharded lowering on one card, not as multi-GPU
speed; gloo moves CUDA tensors through the host. On the CPU the ranks are
processes on the same cores. The bytes are what would cross a real
interconnect.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_multidevice \\
      --device cpu --devices 1,2,4
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.core import rounds, topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.sharding import plans

MODES = ("gather", "psum", "kernel")


def _spec(mode: str, n_clients: int, tau: int, topo: str
          ) -> rounds.RoundSpec:
    return rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=0.05, n_lazy=2, sigma2=0.01,
        mine_attempts=256, difficulty_bits=2,
        topology=topology.from_name(topo),
        fast_allreduce=mode == "psum", fused_mix=mode == "kernel")


def _run_modes(n_rounds, n_clients, samples, tau, reps, device, topo,
               mesh=None) -> dict:
    """Every tier's warm rounds a second on this rank (or one process)."""
    src, params = common.build_experiment(device, n_clients=n_clients,
                                          samples=samples)
    batch = src.static_batch()
    n_dev = 1 if mesh is None else mesh.n_shards
    if mesh is not None:
        rows = plans.block_rows(n_clients, n_dev, mesh.shard_index)
        batch = {k: v[rows] for k, v in batch.items()}
    model_bytes = 4 * sum(v.numel() for v in params.values())
    local = n_clients // n_dev
    out = {}
    for mode in MODES:
        spec = _spec(mode, n_clients, tau, topo)

        def run():
            return rounds.run_blade_fl(mlp_client_losses, spec, params,
                                       batch, n_rounds, seed=2,
                                       device=device, mesh=mesh)

        run()   # warm: the kernels' first launches, the process groups
        t0 = time.perf_counter()
        for _ in range(reps):
            state, hist, ledger = run()
        wall = (time.perf_counter() - t0) / reps
        if n_dev == 1:
            mix_bytes = 0.0
        elif mode == "psum":
            mix_bytes = 2.0 * (n_dev - 1) / n_dev * model_bytes
        else:
            mix_bytes = float((n_clients - local) * model_bytes)
        out[mode] = {
            "devices": n_dev, "mode": mode, "topology": topo,
            "rounds_per_s": n_rounds / wall, "wall_s": wall,
            "model_bytes": model_bytes,
            "est_mix_bytes_per_round": mix_bytes,
            "received_bytes_per_round": (
                dict(rounds.LAST_RECEIVED) if mesh is not None else {}),
            "mix_mode": rounds.LAST_DISPATCH["mix_mode"],
            "driver": rounds.LAST_DISPATCH["driver"],
            "chain_valid": ledger.validate_chain(),
            "final_global_loss": hist[-1]["global_loss"]}
    return out


def _rank_modes(n_rounds, n_clients, samples, tau, reps, device, topo):
    mesh = mesh_lib.make_client_mesh(0, device)
    return _run_modes(n_rounds, n_clients, samples, tau, reps, mesh.device,
                      topo, mesh)


def bench(device_counts=(1, 2, 4), n_rounds: int = 16, n_clients: int = 16,
          samples: int = 64, tau: int = 4, reps: int = 3, device="cuda",
          backend: str = "gloo", topo: str = "full") -> dict:
    """{D: {mode: row, ratios}} over ``device_counts`` (D > 1 as ranks
    of ``backend``), with the psum and kernel tiers' speed and bytes
    against the gather tier's, and each against D = 1's gather tier."""
    out = {}
    for d in device_counts:
        if n_clients % d:
            print(f"# skip devices={d}: {n_clients} clients not divisible")
            continue
        args = (n_rounds, n_clients, samples, tau, reps)
        if d == 1:
            modes = _run_modes(*args, device, topo)
        else:
            modes = mesh_lib.run_world(_rank_modes, d, backend=backend,
                                       device=device,
                                       args=args + (str(device), topo))[0]
        for mode, res in modes.items():
            common.csv_line(
                f"multidevice_{mode}_D{d}_K{n_rounds}_C{n_clients}",
                res["wall_s"] / n_rounds * 1e6,
                f"rounds_per_s={res['rounds_per_s']:.1f}")
        g, p, k = modes["gather"], modes["psum"], modes["kernel"]
        modes["psum_vs_gather_speedup"] = p["rounds_per_s"] \
            / g["rounds_per_s"]
        modes["kernel_vs_gather_speedup"] = k["rounds_per_s"] \
            / g["rounds_per_s"]
        if p["est_mix_bytes_per_round"]:
            modes["gather_vs_psum_bytes_ratio"] = (
                g["est_mix_bytes_per_round"] / p["est_mix_bytes_per_round"])
        out[d] = modes
    if 1 in out:
        base = out[1]["gather"]["rounds_per_s"]
        for modes in out.values():
            for mode in MODES:
                modes[mode]["vs_single_device_gather"] = \
                    modes[mode]["rounds_per_s"] / base
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="1,2,4",
                    help="comma list of rank counts")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--topology", default="full")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo",
                    help="the ranks' process group (nccl needs a card a "
                         "rank)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    counts = tuple(int(x) for x in a.devices.split(","))
    out = bench(counts, a.rounds, a.clients, a.samples, a.tau, a.reps,
                torch.device(a.device), a.backend, a.topology)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
