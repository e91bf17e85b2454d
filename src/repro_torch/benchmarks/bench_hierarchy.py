"""Flat gather against two-level cluster aggregation on a ``("pod",
"data")`` mesh (the JAX package's ``benchmarks/bench_hierarchy.py``).

The same ``ClusterTopology`` run is laid out twice over ``n_dev`` ranks of
one world (the reference uses 8 host devices; the default here is 4 ranks
as 2 pods of 2):

  * ``flat``    a 1-D ``("data",)`` mesh: no pod lines up with a cluster,
    so the mix runs on the gathered set, and each rank receives the other
    ranks' blocks, ``(C - L) * model`` bytes a round (L = C/D);
  * ``cluster`` ``make_cluster_mesh``'s ``("pod", "data")`` mesh with one
    pod a cluster: an all-gather of the other ``S - L`` rows of the
    cluster inside the pod and two model-sized shifts of the cluster mean
    across pods, ``(S - L + 2) * model`` bytes.

Both give the same params and ledger bit for bit on the CPU
(``tests/test_torch_multidevice.py``), so the analytic column is a pure
saving of the mix's communication, and :func:`bench` raises unless the
cluster layout's is strictly smaller. ``received_bytes_per_round`` is
what the mesh counted over the whole round: with the bench's 2 lazy
clients the perturb stage gathers the whole broadcast set in either
layout (a lazy copy's source may be on any rank), and the cluster mix
then takes its pod's rows from that gather, so the round's total is the
flat one's plus the two shifts. Ranks sharing one card or one CPU measure
the lowering's overhead, not an interconnect; the bytes are what would
cross one.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_hierarchy \\
      --device cpu --clusters 2 --devices 4
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

LAYOUTS = ("flat", "cluster")


def _rank_layouts(n_clusters, n_rounds, n_clients, samples, tau, reps,
                  device) -> dict:
    """Both layouts' warm rounds a second and bytes on this rank."""
    meshes = {"flat": mesh_lib.make_client_mesh(0, device),
              "cluster": mesh_lib.make_cluster_mesh(n_clusters, 0, device)}
    src, params = common.build_experiment(meshes["flat"].device,
                                          n_clients=n_clients,
                                          samples=samples)
    spec = rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=0.05, n_lazy=2, sigma2=0.01,
        mine_attempts=256, difficulty_bits=2,
        topology=topology.ClusterTopology(n_clusters=n_clusters))
    model_bytes = 4 * sum(v.numel() for v in params.values())
    out = {}
    for layout, mesh in meshes.items():
        rows = plans.block_rows(n_clients, mesh.n_shards, mesh.shard_index)
        batch = {k: v[rows] for k, v in src.static_batch().items()}

        def run():
            return rounds.run_blade_fl(mlp_client_losses, spec, params,
                                       batch, n_rounds, seed=2,
                                       device=mesh.device, mesh=mesh)

        run()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, hist, ledger = run()
        wall = (time.perf_counter() - t0) / reps
        local = n_clients // mesh.n_shards
        if layout == "cluster":
            mix_bytes = (n_clients // n_clusters - local + 2) * model_bytes
        else:
            mix_bytes = (n_clients - local) * model_bytes
        out[layout] = {
            "layout": layout, "devices": mesh.n_shards,
            "n_clusters": n_clusters,
            "mix_mode": rounds.LAST_DISPATCH["mix_mode"],
            "rounds_per_s": n_rounds / wall, "wall_s": wall,
            "model_bytes": model_bytes,
            "est_mix_bytes_per_round": float(mix_bytes),
            "received_bytes_per_round": dict(rounds.LAST_RECEIVED),
            "chain_valid": ledger.validate_chain(),
            "final_global_loss": hist[-1]["global_loss"],
            "ledger_head": ledger.blocks[-1].header_hash}
    return out


def bench(n_clusters: int = 2, n_dev: int = 4, n_rounds: int = 16,
          n_clients: int = 16, samples: int = 64, tau: int = 4,
          reps: int = 3, device="cuda", backend: str = "gloo") -> dict:
    """Both layouts on one world of ``n_dev`` ranks of ``backend``; raises
    unless the cluster layout's analytic bytes are below the flat one's."""
    out = mesh_lib.run_world(
        _rank_layouts, n_dev, backend=backend, device=device,
        args=(n_clusters, n_rounds, n_clients, samples, tau, reps,
              str(device)))[0]
    for layout in LAYOUTS:
        res = out[layout]
        common.csv_line(
            f"hierarchy_{layout}_G{n_clusters}_D{n_dev}_C{n_clients}",
            res["wall_s"] / n_rounds * 1e6,
            f"rounds_per_s={res['rounds_per_s']:.1f};"
            f"mix_bytes={res['est_mix_bytes_per_round']:.0f}")
    flat_b = out["flat"]["est_mix_bytes_per_round"]
    hier_b = out["cluster"]["est_mix_bytes_per_round"]
    if hier_b >= flat_b:
        # the point of the two-level lowering: strictly fewer bytes than
        # the flat gather at equal C
        raise ValueError(f"hierarchical bytes {hier_b} not < flat {flat_b}")
    out["flat_vs_cluster_bytes_ratio"] = flat_b / hier_b
    out["cluster_vs_flat_speedup"] = (out["cluster"]["rounds_per_s"]
                                      / out["flat"]["rounds_per_s"])
    out["same_ledger"] = (out["flat"]["ledger_head"]
                          == out["cluster"]["ledger_head"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default="gloo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    a = ap.parse_args(argv)
    out = bench(a.clusters, a.devices, a.rounds, a.clients, a.samples, a.tau,
                a.reps, torch.device(a.device), a.backend)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
