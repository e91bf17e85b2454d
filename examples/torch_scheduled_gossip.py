"""Scheduled (time-varying) topologies on the PyTorch/CUDA port: gossip
rotation, epoch alternation and SNR link-quality fading, with spectral-gap
diagnostics.

``examples/scheduled_gossip.py`` over the port's API. A static ring keeps
talking to the same neighbors, so disagreement between far-apart clients
contracts slowly (a small spectral gap 1 - |lambda_2(W)|). A one-peer
gossip rotation moves the same budget of one partner a client around the
ring: each phase barely mixes, but the product over one period mixes
almost like a full mesh; the ergodic gap is the per-round rate that
product achieves. On the card each schedule runs on the graph driver, one
CUDA graph a phase. On the GPU by default.

  PYTHONPATH=src python examples/torch_scheduled_gossip.py
  PYTHONPATH=src python examples/torch_scheduled_gossip.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import rounds, spectral, topology
from repro_torch.core.aggregation import aggregate_once, client_divergence
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=11,
                    help="one rotation period at 12 clients")
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--samples", type=int, default=128,
                    help="samples a client")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    c, k = args.clients, args.rounds
    gen = torch.Generator().manual_seed(0)
    data = FLDataSource(gen, c, args.samples, dirichlet_alpha=0.2,
                        device=dev)
    params = init_mlp(gen)

    cases = [
        ("full mesh (paper)", topology.FullMesh()),
        ("static ring, 1 nbr", topology.Ring(neighbors=1)),
        ("gossip rotation", topology.GossipRotation()),
        ("alt: ring x3 + mesh", topology.AlternatingSchedule(
            ((topology.Ring(neighbors=1), 3), (topology.FullMesh(), 1)))),
        ("snr fading (period 8)", topology.LinkQualitySchedule(
            fading_period=8)),
    ]
    print(f"{'schedule':>22} {'loss@K':>8} {'eval_acc':>8} {'spread':>10} "
          f"{'gap/round':>9} {'erg_gap':>8}")
    out = {}
    for name, topo in cases:
        spec = rounds.RoundSpec(n_clients=c, tau=args.tau, eta=0.1,
                                mine_attempts=64, difficulty_bits=2,
                                topology=topo)
        state, hist, ledger = rounds.run_blade_fl(
            mlp_client_losses, spec, params, data.static_batch(), k,
            seed=2, device=dev)
        assert ledger.validate_chain()
        spread = float(client_divergence(state.params))
        with torch.no_grad():
            _, m = mlp_loss(aggregate_once(state.params), data.eval_data)
        rep = spectral.gap_report(topo, c, k)
        out[name] = {"global_loss": hist[-1]["global_loss"],
                     "spread": spread, "ergodic_gap": rep["ergodic_gap"],
                     "chain_valid": ledger.validate_chain()}
        print(f"{name:>22} {hist[-1]['global_loss']:>8.4f} "
              f"{float(m['accuracy']):>8.3f} {spread:>10.3e} "
              f"{rep['gap_mean']:>9.4f} {rep['ergodic_gap']:>8.4f}")

    # the rotation's partner cycles round-robin; each phase is one pair of
    # rolls, yet the period mixes everything
    rot = topology.GossipRotation()
    print("\nrotation partners (client 0), C=6:",
          [(0 + rot.shift_at(t, 6)) % 6 for t in range(rot.period(6))])
    print("per-phase gap:",
          np.round(spectral.per_round_gaps(rot, 6, rot.period(6)), 3))
    print("ergodic gap over one period:",
          round(spectral.ergodic_gap(rot, 6), 4))
    return out


if __name__ == "__main__":
    main()
