"""End-to-end BLADE-FL trainer of the port (paper-scale MLP).

Runs the paper's §7 substrate: C clients train the 784-256-10 MLP on the
Dirichlet-split MNIST proxy for K integrated rounds (training, lazy
clients, digest, FedAvg, mining, ledger), on the GPU by default.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --k 2 \\
      --clients 4 --device cpu

It prints the JSON keys of the JAX package's ``launch/train.py::run_mlp``
except the spectral fields and ``fast_allreduce``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import BladeConfig
from repro_torch.core import aggregation, allocation, rounds
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss


def spec_of(blade: BladeConfig, eval_every: int = 1) -> rounds.RoundSpec:
    """The round configuration the paper's budget implies (eqs. 1-3)."""
    tau = allocation.tau_from_budget(blade.t_sum, blade.K, blade.alpha,
                                     blade.beta)
    return rounds.RoundSpec(
        n_clients=blade.n_clients, tau=max(tau, 1), eta=blade.eta,
        n_lazy=blade.n_lazy, sigma2=blade.sigma2, dp_sigma=blade.dp_sigma,
        mine_attempts=allocation.mining_iterations(blade.beta),
        difficulty_bits=4, eval_every=eval_every)


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
    spec = spec_of(blade, args.eval_every)
    gen = torch.Generator(device="cpu").manual_seed(blade.seed)
    src = FLDataSource(gen, blade.n_clients, blade.samples_per_client,
                       blade.dirichlet_alpha, seed=blade.seed, device=dev)
    return blade, spec, src, init_mlp(gen), dev


def train_mlp(args):
    """Run the MLP experiment; returns (result dict, final RoundState,
    history)."""
    blade, spec, src, params, dev = prepare_mlp(args)
    t0 = time.time()
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.static_batch(), blade.K,
        seed=blade.seed + 2, device=dev)
    # final eval on held-out data with the aggregated model
    final = aggregation.aggregate_once(state.params)
    with torch.no_grad():
        loss, metrics = mlp_loss(final, src.eval_data)
    result = {
        "K": blade.K, "tau": spec.tau, "final_eval_loss": float(loss),
        "final_eval_acc": float(metrics["accuracy"]),
        "final_global_loss": hist[-1].get("global_loss"),
        "chain_valid": ledger.validate_chain(), "blocks": len(ledger.blocks),
        "devices": 1,
        "dispatch": {"rounds": "python loop", "device": str(dev),
                     "kernels": "cuda" if dev.type == "cuda" else "plain"},
        "wall_s": time.time() - t0,
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None):
    run_mlp(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
