"""Byzantine attack against robust aggregation on the PyTorch/CUDA port,
side by side.

``examples/byzantine_defense.py`` over the port's API. Three runs on a
ring(2) topology, same data and seeds, only the adversary and the defense
change:

  1. clean baseline        linear ring mix, no attack
  2. ALIE vs linear        3 colluding "a little is enough" attackers bias
                           every coordinate of the mean from inside the
                           honest variance envelope
  3. ALIE vs trimmed mean  the same attack against RoundSpec.robust_agg =
                           "trimmed:3": the order statistic drops the
                           colluding tail per coordinate

Then the in-round detector's suspect mask on one attacked broadcast set,
and the held-out loss gap each configuration pays. On the GPU by default.

  PYTHONPATH=src python examples/torch_byzantine_defense.py --rounds 6
  PYTHONPATH=src python examples/torch_byzantine_defense.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import attacks, detection, rounds, topology
from repro_torch.core.aggregation import aggregate_once, replicate
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss


def _spec(n_clients, tau, atk=None, robust=None):
    return rounds.RoundSpec(
        n_clients=n_clients, tau=tau, eta=0.05, mine_attempts=64,
        difficulty_bits=2, topology=topology.Ring(neighbors=2),
        attack=atk, robust_agg=robust)


def run(name, src, params, k_rounds, dev, atk=None, robust=None,
        n_clients=12, tau=2):
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, _spec(n_clients, tau, atk, robust), params,
        src.static_batch(), k_rounds, seed=2, device=dev)
    with torch.no_grad():
        eval_loss, m = mlp_loss(aggregate_once(state.params), src.eval_data)
    print(f"\n== {name} ==")
    print(f"  mix: {rounds.LAST_DISPATCH['mix']} "
          f"({rounds.LAST_DISPATCH['mix_mode']}), "
          f"chain valid: {ledger.validate_chain()}")
    for i, h in enumerate(hist):
        print(f"  round {i}: global_loss={h['global_loss']:.4f} "
              f"divergence={h['divergence']:.3e}")
    print(f"  final eval_loss={float(eval_loss):.4f} "
          f"accuracy={float(m['accuracy']):.3f}")
    assert ledger.validate_chain()
    return float(eval_loss)


def show_detection(src, params, atk, dev, n_clients=12):
    """One round's broadcast set under attack, before any mix: what the
    detector sees in Step 2."""
    spec = _spec(n_clients, 2, atk)
    local_train = rounds.make_local_train(mlp_client_losses, spec)
    params = {k: v.to(dev) for k, v in params.items()}
    p, _ = local_train(replicate(params, n_clients), src.static_batch())
    p = rounds.make_attack(spec)(p, torch.Generator().manual_seed(99))
    width = sum(v[0].numel() for v in p.values())
    mask, _ = detection.detect_lazy_round(
        p, params, detection.sketch_projection(width, device=dev))
    met = detection.detection_metrics(mask, atk.n_attackers)
    flags = "".join("X" if f else "." for f in mask.tolist())
    print(f"\nper-client suspect mask (first {atk.n_attackers} are the "
          f"cabal): [{flags}]")
    how = ("colluding ALIE broadcasts are identical -> plagiarism test"
           if isinstance(atk, attacks.ALIE) else "update-norm outlier test")
    print(f"detection precision={met['precision']:.2f} "
          f"recall={met['recall']:.2f} flagged={met['flagged']}  ({how})")
    return met


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--samples", type=int, default=64,
                    help="samples a client")
    ap.add_argument("--attackers", type=int, default=3)
    ap.add_argument("--z", type=float, default=1.5)
    ap.add_argument("--attack", default=None,
                    help="override the ALIE default: signflip[:scale] | "
                         "noise[:sigma2[:scale]] | alie[:z] | "
                         "replace[:boost]")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    src = FLDataSource(gen, args.clients, args.samples, seed=0, device=dev)
    params = init_mlp(gen)
    atk = (attacks.from_name(args.attack, args.attackers) if args.attack
           else attacks.ALIE(n_attackers=args.attackers, z=args.z))
    print(f"{args.clients} clients, {args.attackers} x "
          f"{type(atk).__name__} attackers, ring(2) topology, "
          f"K={args.rounds}, on {dev}")
    c = args.clients
    clean = run("clean baseline (linear ring)", src, params, args.rounds,
                dev, n_clients=c)
    name = type(atk).__name__
    attacked = run(f"{name} vs linear ring", src, params, args.rounds, dev,
                   atk=atk, n_clients=c)
    defended = run(f"{name} vs trimmed:3", src, params, args.rounds, dev,
                   atk=atk, robust="trimmed:3", n_clients=c)
    met = show_detection(src, params, atk, dev, c)
    print(f"\nfinal eval-loss gap vs clean: "
          f"linear {attacked - clean:+.4f}, "
          f"trimmed {defended - clean:+.4f}")
    print("(try --attack signflip:8 to watch the linear gap explode while "
          "trimmed stays pinned; repro_torch.benchmarks.bench_robust "
          "sweeps this)")
    return {"clean": clean, "attacked": attacked, "defended": defended,
            "detection": met}


if __name__ == "__main__":
    main()
