"""Communication topologies on the PyTorch/CUDA port: the same BLADE-FL
run under full mesh, ring gossip, per-round link dropout and static
partial participation.

``examples/gossip_topologies.py`` over the port's API. The paper's Steps
2+5 are a full mesh: after every round all clients hold the same
aggregate, so the client spread is zero. Another ``RoundSpec.topology``
(same data, same seeds, same chain) makes Steps 2+5 a row-stochastic
mixing matrix: under ring gossip or link dropout the clients no longer
reach consensus each round, and learning slows at the same budget. On the
GPU by default.

  PYTHONPATH=src python examples/torch_gossip_topologies.py
  PYTHONPATH=src python examples/torch_gossip_topologies.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import rounds, topology
from repro_torch.core.aggregation import aggregate_once, client_divergence
from repro_torch.data.pipeline import FLDataSource
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--samples", type=int, default=128,
                    help="samples a client")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    c = args.clients
    gen = torch.Generator().manual_seed(0)
    data = FLDataSource(gen, c, args.samples, dirichlet_alpha=0.2,
                        device=dev)
    params = init_mlp(gen)

    topologies = [
        ("full mesh (paper)", topology.FullMesh()),
        ("ring, 1 neighbor", topology.Ring(neighbors=1)),
        ("ring, 2 neighbors", topology.Ring(neighbors=2)),
        ("link dropout p=0.5", topology.RandomGraph(p_link=0.5)),
        (f"partial, {c // 2} of {c}",
         topology.PartialParticipation(n_active=max(c // 2, 1))),
    ]
    print(f"{'topology':>20} {'loss@K':>8} {'eval_acc':>8} "
          f"{'post-round spread':>18}")
    out = {}
    for name, topo in topologies:
        spec = rounds.RoundSpec(n_clients=c, tau=args.tau, eta=0.1,
                                mine_attempts=64, difficulty_bits=2,
                                topology=topo)
        # static batch -> the graph driver on the card, the loop on the CPU
        state, hist, ledger = rounds.run_blade_fl(
            mlp_client_losses, spec, params, data.static_batch(),
            args.rounds, seed=2, device=dev)
        assert ledger.validate_chain()
        # a full mesh collapses the client spread every round; the other
        # topologies leave disagreement behind
        spread = float(client_divergence(state.params))
        with torch.no_grad():
            _, m = mlp_loss(aggregate_once(state.params), data.eval_data)
        out[name] = {"global_loss": hist[-1]["global_loss"],
                     "accuracy": float(m["accuracy"]), "spread": spread,
                     "chain_valid": ledger.validate_chain()}
        print(f"{name:>20} {hist[-1]['global_loss']:>8.4f} "
              f"{float(m['accuracy']):>8.3f} {spread:>18.3e}")

    print("\nring(1) mixing matrix, C=5:")
    print(np.round(topology.Ring(1).matrix(5), 3))
    return out


if __name__ == "__main__":
    main()
