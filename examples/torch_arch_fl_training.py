"""BLADE-FL integrated rounds around an LM arch on the PyTorch/CUDA port:
``examples/arch_fl_training.py`` over the port's API, plus ``--size`` and
``--device``. Clients train the arch on synthetic token streams (tau GD
iterations each a round, one lazy client), the aggregate is hash-chained,
and the per-round global loss and the chain are printed. On the GPU by
default.

  PYTHONPATH=src python examples/torch_arch_fl_training.py --device cpu
  PYTHONPATH=src python examples/torch_arch_fl_training.py \\
      --size one-h100 --rounds 3 --tau 2 --seq 256     # xlstm-125m whole
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import tree
from repro_torch.configs import (ShapeConfig, get_one_h100_arch,
                                 get_smoke_arch)
from repro_torch.core import rounds, topology
from repro_torch.data.pipeline import LMDataSource
from repro_torch.device import resolve_device
from repro_torch.models import registry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--size", choices=("smoke", "one-h100"), default="smoke")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lazy", type=int, default=1)
    ap.add_argument("--topology", default="full",
                    help="full | ring[:k] | random[:p] | partial:n")
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (get_smoke_arch(args.arch) if args.size == "smoke"
           else get_one_h100_arch(args.arch))
    shape = ShapeConfig("t", args.seq, args.clients * 4, "train")
    src = LMDataSource(cfg, shape, args.clients, device=dev)
    params = {k: v.to(dev) for k, v in tree.flatten(registry.init_model(
        torch.Generator().manual_seed(0), cfg)).items()}
    n_params = sum(v.numel() for v in params.values())
    print(f"{cfg.name}: {n_params:,} params x {args.clients} clients, "
          f"tau={args.tau}, {args.rounds} rounds, {args.lazy} lazy")

    spec = rounds.RoundSpec(n_clients=args.clients, tau=args.tau, eta=5e-3,
                            n_lazy=args.lazy, sigma2=1e-4,
                            mine_attempts=512, difficulty_bits=3,
                            eval_every=args.eval_every,
                            topology=topology.from_name(args.topology))
    # per-round token streams, stacked [K, C, ...]: one static batch, which
    # the card runs by the graph driver
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec, params,
        src.stacked_batches(args.rounds), args.rounds, seed=1, device=dev,
        stacked=True)
    for k, h in enumerate(hist):
        print(f"round {k}: loss={h['global_loss']:.4f} "
              f"divergence={h['divergence']:.3e} miner={int(h['winner'])}")
    print(f"chain valid: {ledger.validate_chain()} "
          f"({len(ledger.blocks)} blocks)")
    return state, hist, ledger


if __name__ == "__main__":
    main()
