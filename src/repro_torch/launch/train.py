"""End-to-end BLADE-FL trainer of the port (paper-scale MLP).

Runs the paper's §7 substrate: C clients train the 784-256-10 MLP on the
Dirichlet-split MNIST proxy for K integrated rounds (training, lazy
clients, attacks, digest, the topology's mix, mining, ledger), on the GPU
by default.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --k 2 \\
      --clients 4 --topology random:0.5 --fused-mix --device cpu

It prints the JSON keys of the JAX package's ``launch/train.py::run_mlp``
except ``fast_allreduce`` (the port runs on one device). ``--out-dir DIR``
appends each round's history entry to ``DIR/blade_mlp.jsonl``, as the JAX
package's trainer does.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import BladeConfig
from repro_torch.core import aggregation, allocation, attacks, rounds, \
    spectral, topology
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss
from repro_torch.training.metrics import MetricLogger


def spec_of(blade: BladeConfig, eval_every: int = 1,
            **fields) -> rounds.RoundSpec:
    """The round configuration the paper's budget implies (eqs. 1-3);
    ``fields`` sets the scenario fields (topology, attack, ...)."""
    tau = allocation.tau_from_budget(blade.t_sum, blade.K, blade.alpha,
                                     blade.beta)
    return rounds.RoundSpec(
        n_clients=blade.n_clients, tau=max(tau, 1), eta=blade.eta,
        n_lazy=blade.n_lazy, sigma2=blade.sigma2, dp_sigma=blade.dp_sigma,
        mine_attempts=allocation.mining_iterations(blade.beta),
        difficulty_bits=4, eval_every=eval_every, **fields)


def spectral_fields(spec: rounds.RoundSpec, n_rounds: int, table) -> dict:
    """1 - lambda_2(W) diagnostics of the run's topology or schedule, over
    ``table``, the ``[M, C, C]`` matrices the run mixed with: the
    per-round gap stats and the ergodic (product-matrix) gap."""
    rep = spectral.gap_report(spec.topology, spec.n_clients, n_rounds,
                              matrices=table)
    return {"spectral_gap_mean": rep["gap_mean"],
            "spectral_gap_min": rep["gap_min"],
            "ergodic_gap": rep["ergodic_gap"],
            "predicted_consensus_rate": rep["predicted_consensus_rate"]}


def adversary_fields(args) -> dict:
    """``RoundSpec`` fields of the Byzantine scenario: ``--attack`` (with
    ``--attackers`` adversarial clients) and ``--robust`` (the aggregator
    the resolver parses; ``mean`` keeps the linear mix)."""
    out = {}
    if args.attack:
        out["attack"] = attacks.from_name(args.attack, args.attackers)
    if args.robust:
        out["robust_agg"] = args.robust
    return out


def prepare_mlp(args):
    """Config, round spec, data and initial model of the MLP experiment.
    Data and the initial model are drawn on the CPU from the seed and
    moved to the device, so a seed gives the same inputs on every
    device."""
    dev = resolve_device(args.device)
    blade = BladeConfig(n_clients=args.clients, n_lazy=args.lazy,
                        sigma2=args.sigma2, t_sum=args.t_sum,
                        alpha=args.alpha, beta=args.beta, eta=args.eta,
                        K=args.k, dp_sigma=args.dp_sigma, seed=args.seed)
    spec = spec_of(blade, args.eval_every,
                   topology=topology.from_name(args.schedule
                                               or args.topology),
                   fused_mix=args.fused_mix, **adversary_fields(args))
    gen = torch.Generator(device="cpu").manual_seed(blade.seed)
    src = FLDataSource(gen, blade.n_clients, blade.samples_per_client,
                       blade.dirichlet_alpha, seed=blade.seed, device=dev)
    return blade, spec, src, init_mlp(gen), dev


def train_mlp(args, jit: bool = True):
    """Run the MLP experiment; returns (result dict, final RoundState,
    history). The rounds run on the driver ``rounds.dispatch_plan`` picks;
    ``jit=False`` keeps them in the loop (``result["dispatch"]`` says
    which)."""
    blade, spec, src, params, dev = prepare_mlp(args)
    log = MetricLogger(args.out_dir, "blade_mlp")
    seed = blade.seed + 2
    t0 = time.time()
    # the run's mixing matrices, drawn once: the rounds mix with them and
    # the spectral report reads them
    table = topology.round_table(spec.topology, spec.n_clients, blade.K,
                                 topology.topology_generator(seed))
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.static_batch(), blade.K,
        seed=seed, device=dev, topology_matrices=table, jit=jit)
    # final eval on held-out data with the aggregated model
    final = aggregation.aggregate_once(state.params)
    with torch.no_grad():
        loss, metrics = mlp_loss(final, src.eval_data)
    for i, h in enumerate(hist):
        log.log(i, **h)
    result = {
        "K": blade.K, "tau": spec.tau, "final_eval_loss": float(loss),
        "final_eval_acc": float(metrics["accuracy"]),
        "final_global_loss": hist[-1].get("global_loss"),
        "chain_valid": ledger.validate_chain(), "blocks": len(ledger.blocks),
        "devices": 1,
        "dispatch": dict(rounds.LAST_DISPATCH),
        "wall_s": time.time() - t0,
        **spectral_fields(spec, blade.K, table),
    }
    return result, state, hist


def run_mlp(args) -> dict:
    result, _, _ = train_mlp(args)
    print(json.dumps(result, indent=1))
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mlp", choices=["mlp"],
                    help="only the paper's MLP is ported so far")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--lazy", type=int, default=0)
    ap.add_argument("--sigma2", type=float, default=0.0)
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=10.0)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="global-loss eval stride (NaN on skipped rounds)")
    ap.add_argument("--topology", default="full",
                    help="Steps 2+5 mixing: full | ring[:k] | random[:p] | "
                         "partial:n | shift[:s] | cluster:g[:a] "
                         "(core/topology.py)")
    ap.add_argument("--schedule", default=None,
                    help="time-varying topology schedule (overrides "
                         "--topology): rotate[:step] | alt[:k[:m]] | "
                         "snr[:period] (core/topology.py Schedules)")
    ap.add_argument("--attack", default=None,
                    help="Byzantine attack stage on the pre-broadcast "
                         "params: signflip[:scale] | noise[:sigma2[:scale]] "
                         "| alie[:z] | replace[:boost] (core/attacks.py); "
                         "the first --attackers clients are adversarial")
    ap.add_argument("--attackers", type=int, default=1,
                    help="adversarial client count for --attack (first-M "
                         "convention, like --lazy)")
    ap.add_argument("--robust", default=None,
                    help="Byzantine-robust aggregation override: mean | "
                         "median | trimmed[:t] | geomed[:iters] — order "
                         "statistics over the full broadcast set instead "
                         "of the linear mix")
    ap.add_argument("--fused-mix", action="store_true",
                    help="contract dense mixes through the mix_rows_flat "
                         "CUDA kernel (kernels/fedavg) instead of "
                         "torch.matmul; the digest/divergence sweep is "
                         "fused on every path")
    ap.add_argument("--out-dir", default=None,
                    help="append each round's metrics to "
                         "OUT_DIR/blade_mlp.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None):
    run_mlp(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
