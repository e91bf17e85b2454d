"""Quickstart on the PyTorch/CUDA port: a complete BLADE-FL run.

20 clients, non-IID synthetic MNIST proxy, K=5 integrated rounds under a
t_sum=100 budget — local training, lazy clients, PoW mining, hash-chained
blocks, decentralized aggregation — then evaluate the final global model.
``examples/quickstart.py`` over the port's API; on the GPU by default.

  PYTHONPATH=src python examples/torch_quickstart.py                # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import BladeConfig
from repro_torch.core import allocation, rounds, topology
from repro_torch.core.aggregation import aggregate_once
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    blade = BladeConfig(n_clients=20, K=5, t_sum=100.0, alpha=1.0, beta=10.0,
                        eta=0.05, n_lazy=2, sigma2=0.01)
    tau = allocation.tau_from_budget(blade.t_sum, blade.K, blade.alpha,
                                     blade.beta)
    print(f"budget t_sum={blade.t_sum}: K={blade.K} rounds x "
          f"(tau={tau} local iters + mining)")

    gen = torch.Generator(device="cpu").manual_seed(0)
    data = FLDataSource(gen, blade.n_clients, blade.samples_per_client,
                        blade.dirichlet_alpha, device=dev)
    params = init_mlp(gen)
    # topology=FullMesh() is the paper's Step 2+5 (broadcast to all, adopt
    # the aggregate) and the default
    spec = rounds.RoundSpec(
        n_clients=blade.n_clients, tau=tau, eta=blade.eta,
        n_lazy=blade.n_lazy, sigma2=blade.sigma2,
        mine_attempts=allocation.mining_iterations(blade.beta),
        difficulty_bits=4, topology=topology.FullMesh())

    # static_batch() (full-batch GD reuses one [C, m, ...] batch) routes
    # run_blade_fl on the card to the graph driver: a warm round, then the
    # round replayed as a CUDA graph, one host transfer at the end
    state, history, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, data.static_batch(), blade.K,
        seed=2, device=dev)
    print(f"driver: {rounds.LAST_DISPATCH['driver']} "
          f"({rounds.LAST_DISPATCH['reason']})")

    for k, h in enumerate(history):
        print(f"round {k}: global_loss={h['global_loss']:.4f} "
              f"miner={int(h['winner'])} hash={int(h['pow_hash']):#010x}")
    with torch.no_grad():
        loss, metrics = mlp_loss(aggregate_once(state.params), data.eval_data)
    print(f"\nchain valid: {ledger.validate_chain()} "
          f"({len(ledger.blocks)} blocks)")
    print(f"final eval: loss={float(loss):.4f} "
          f"accuracy={float(metrics['accuracy']):.3f}")
    return ledger


if __name__ == "__main__":
    main()
