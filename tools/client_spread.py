#!/usr/bin/env python3
"""Read how far the card's per-client params drift from the CPU's on the
FL paths without consensus, at a depth of K rounds.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/client_spread.py [--k 20]

For the ring path and the topology path (``chip_smoke.RING_ARGS`` and
``chip_smoke.TOPOLOGY_ARGS``: the paper's configuration with ``--topology
ring``, or ``--topology random:0.5 --fused-mix``) it runs
``launch.train`` for K rounds on the card (the graph driver, which
``chip_smoke.py`` holds bitwise to the loop driver) and on the CPU (plain
versions, the same draws, the loop driver) and prints, with the drivers, per path, the worst |card - cpu| / (atol +
rtol |cpu|) (``chip_smoke.CARD_CPU_ATOL`` / ``CARD_CPU_RTOL``) of the
per-round metrics and of each client-stacked param, beside
``chip_smoke.CLIENT_SPREAD_LIMIT``. A reading, not a gate: it exits 0
whatever the spread. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=20)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("client_spread: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def ratio(a, b):
        a = torch.as_tensor(a, dtype=torch.float64).cpu()
        b = torch.as_tensor(b, dtype=torch.float64)
        return float(((a - b).abs() / (cs.CARD_CPU_ATOL + cs.CARD_CPU_RTOL
                                       * b.abs())).max())

    for name, flags in (("ring", cs.RING_ARGS), ("topology", cs.TOPOLOGY_ARGS)):
        flags = flags + ["--k", str(opts.k)]   # the last --k wins
        runs = {}
        for dev in ("cuda:0", "cpu"):
            args = train.build_parser().parse_args(flags + ["--device", dev])
            result, state, hist = train.train_mlp(args)
            runs[dev] = (result, state, hist)
        (result, state, hist), (cpu_result, cpu_state, cpu_hist) = \
            runs["cuda:0"], runs["cpu"]
        metrics = {key: max(ratio(a[key], b[key]) for a, b in
                            zip(hist, cpu_hist))
                   for key in ("local_loss_mean", "global_loss",
                               "divergence")}
        clients = {key: ratio(v, cpu_state.params[key])
                   for key, v in state.params.items()}
        print(json.dumps({"path": name, "k": opts.k,
                          "drivers": {
                              "card": result["dispatch"]["driver"],
                              "cpu": cpu_result["dispatch"]["driver"]},
                          "metrics_worst_of_tolerance": metrics,
                          "per_client_params_worst_of_tolerance": clients,
                          "worst": max(clients.values()),
                          "limit": cs.CLIENT_SPREAD_LIMIT}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
