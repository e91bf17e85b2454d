"""Lazy-client study (paper §5) on the PyTorch/CUDA port: how plagiarism
plus artificial noise degrade BLADE-FL, and how the optimal allocation
shifts (Corollary 5); then the in-round plagiarism detector.

``examples/lazy_clients.py`` over the port's API: each sweep is
``repro_torch.benchmarks.common.sweep_k`` (a static batch, so every run
takes the graph driver on the card). On the GPU by default.

  PYTHONPATH=src python examples/torch_lazy_clients.py
  PYTHONPATH=src python examples/torch_lazy_clients.py --device cpu \\
      --clients 4 --samples 8 --t-sum 24
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.benchmarks import common
from repro_torch.core import rounds
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses


def sweeps(args, dev):
    c = args.clients
    sweep = dict(n_clients=c, beta=6.0, samples=args.samples,
                 t_sum=args.t_sum, device=dev)
    out = {"lazy_ratio": {}, "noise_power": {}}
    print("lazy-ratio sweep (sigma^2 = 0.01, beta = 6)")
    print(f"{'M/N':>5} {'K*':>3} {'train_time':>10} {'loss':>8} {'acc':>6}")
    for frac in (0.0, 0.1, 0.2, 0.3):
        best = common.best_of(common.sweep_k(n_lazy=int(c * frac),
                                             sigma2=0.01, **sweep))
        out["lazy_ratio"][frac] = best
        print(f"{frac:>5.0%} {best['k']:>3} {best['train_time']:>10.0f} "
              f"{best['final_loss']:>8.4f} {best['accuracy']:>6.3f}")
    print(f"\nnoise-power sweep (M/N = {max(c // 5, 1) / c:.0%})")
    print(f"{'s^2':>5} {'K*':>3} {'train_time':>10} {'loss':>8} {'acc':>6}")
    for s2 in (0.01, 0.1, 0.3):
        best = common.best_of(common.sweep_k(n_lazy=max(c // 5, 1),
                                             sigma2=s2, **sweep))
        out["noise_power"][s2] = best
        print(f"{s2:>5.2f} {best['k']:>3} {best['train_time']:>10.0f} "
              f"{best['final_loss']:>8.4f} {best['accuracy']:>6.3f}")
    return out


def detection_demo(dev, n_clients=10, samples=128):
    """Beyond the paper: in-round plagiarism detection (paper §8, future
    work), three rounds with 3 lazy clients."""
    gen = torch.Generator().manual_seed(0)
    src = FLDataSource(gen, n_clients, samples, device=dev)
    params = {k: v.to(dev) for k, v in init_mlp(gen).items()}
    spec = rounds.RoundSpec(n_clients=n_clients, tau=6, eta=0.2, n_lazy=3,
                            sigma2=0.01, mine_attempts=64, detect_lazy=True)
    round_fn = rounds.make_integrated_round(mlp_client_losses, spec,
                                            device=dev)
    state = rounds.init_state(params, n_clients,
                              torch.Generator().manual_seed(2))
    print("\nin-round plagiarism detection (3 true lazy clients):")
    flagged = []
    for k in range(3):
        state, m = round_fn(state, src.round_batch(k))
        flagged.append(int(m["n_suspects"]))
        print(f"  round {k}: flagged {flagged[-1]} suspects")
    return flagged


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--samples", type=int, default=192,
                    help="samples a client")
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--detect-clients", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = sweeps(args, dev)
    out["flagged"] = detection_demo(dev, args.detect_clients,
                                    min(args.samples, 128))
    return out


if __name__ == "__main__":
    main()
