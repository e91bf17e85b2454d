#!/usr/bin/env python3
"""Time the port's Step 3+4 mine stage (PoW race, winner, hash link) on one
NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/mine_stage_bench.py [--src DIR] [--label NAME]

At the paper's configuration (C = 20 clients, 10 240 attempts, difficulty
4) it measures, each with ``chip_smoke.kernel_ms`` (profiler
device time, CUDA-event time over back-to-back calls, device operations a
call):

- an empty kernel launch, the floor under any single launch;
- the race ``ops.pow_race_flat`` at C = 20 and at C = 1;
- one call of the mine stage ``rounds.make_mine``, and its host ms (the
  host clock over back-to-back calls, without a synchronize);
- where the tree has it, ``ops.mine_seal`` at C = 20, at C = 1 and at
  C = 20 with 2**20 attempts (several blocks a client); both modes at
  C = 20 with the tile forced to each of CHUNK_SWEEP; flat mode at
  LARGE_CASES; empty launches of EMPTY_SHAPES;
- the paper's path run by the loop driver (``jit=False``, where the tree
  also has the graph driver): ms a round on the host clock, device
  operations and device ms a round, and the driver's name.

``--src`` names the ``src`` directory of the tree to measure (default:
this checkout's), so that a parent tree unpacked under ``build/`` is
measured with the same helpers. Prints one JSON line of results and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIENTS, ATTEMPTS, DIFFICULTY = 20, 10240, 4
LARGE_ATTEMPTS = 1 << 20
# (C, n_attempts) of several blocks a client, flat mode (the seal at
# LARGE_ATTEMPTS is timed above)
LARGE_CASES = [(1, 1 << 24), (20, 40000)]
# (blocks, threads) of empty launches beside the floor's (1, 32)
EMPTY_SHAPES = [(1, 1024), (20, 1024), (20, 256)]
# forced tiles at the paper's budget: 1, 4 and 10 blocks a client
CHUNK_SWEEP = [10240, 2560, 1024]


def host_ms(torch, fn, reps=200, warmup=5):
    """Host ms per call of ``fn`` over ``reps`` back-to-back calls, with no
    synchronize between them: what the host spends to launch one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


def rounds_of_paper_path(torch, cs, dev, runs=5):
    """The paper's path (``chip_smoke.MAIN_ARGS``, K = 5): host-clock ms per
    round of ``runs`` warm runs of ``rounds.run_blade_fl`` by the loop
    driver (a tree with a graph driver takes ``jit=False``; an older one
    has only the loop), then one run under the profiler for its device
    operations and device ms a round."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    args = train.build_parser().parse_args(cs.MAIN_ARGS
                                           + ["--device", str(dev)])
    blade, spec, src, params, _ = train.prepare_mlp(args)
    batch = src.static_batch()
    loop = ({"jit": False} if "jit" in inspect.signature(
        rounds.run_blade_fl).parameters else {})

    def run():
        rounds.run_blade_fl(mlp_client_losses, spec, params, batch, blade.K,
                            seed=blade.seed + 2, device=dev, **loop)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        walls.append(1e3 * (time.perf_counter() - t0) / blade.K)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    return {"driver": rounds.LAST_DISPATCH["driver"], "round_ms": walls,
            "round_device_ops": cs.device_ops(torch, prof) / blade.K,
            "round_device_ms": cs.device_us(torch, prof) / 1e3 / blade.K}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="tree")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mine_stage_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(opts.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.core import mining, rounds
    from repro_torch.kernels import _build
    from repro_torch.kernels.pow_hash import ops as pow_ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all(["pow_race"])

    def word(v):
        return torch.full((), int(v) & mining.MASK, dtype=torch.int64,
                          device=dev)

    tag = opts.label
    gen = torch.Generator().manual_seed(7)
    payloads = torch.randint(0, 2 ** 32, (N_CLIENTS,), generator=gen,
                             dtype=torch.int64).to(dev)
    prev, digest, off = word(99), word(0xCAFE), word(4 << 20)
    out = {"label": tag, "src": os.path.relpath(opts.src, ROOT)}
    empty = cs.empty_launch(torch)
    out["floor_ms"] = cs.kernel_ms(torch, empty, f"{tag} empty launch",
                                   reps=50)
    # the parent tree's wrappers default to chunk 1024; this tree's pick
    # their own grid
    out["race_c20_ms"] = cs.kernel_ms(
        torch, lambda: pow_ops.pow_race_flat(prev, payloads, off, ATTEMPTS),
        f"{tag} pow_race_flat C=20", reps=50)
    one = payloads[:1].contiguous()
    out["race_c1_ms"] = cs.kernel_ms(
        torch, lambda: pow_ops.pow_race_flat(prev, one, off, ATTEMPTS),
        f"{tag} pow_race_flat C=1", reps=50)
    spec = rounds.RoundSpec(n_clients=N_CLIENTS, tau=10, eta=0.05,
                            mine_attempts=ATTEMPTS,
                            difficulty_bits=DIFFICULTY)
    mine = rounds.make_mine(spec)
    stage = lambda: mine(prev, digest, 3)   # noqa: E731
    # few calls: about 80 launches each on the parent tree, all queued
    # behind the events' spin kernel
    out["mine_stage_ms"] = cs.kernel_ms(torch, stage, f"{tag} make_mine",
                                        reps=10)
    out["mine_stage_host_ms"] = host_ms(torch, stage)
    if hasattr(pow_ops, "mine_seal"):
        for name, c, n in (("seal_c20", N_CLIENTS, ATTEMPTS),
                           ("seal_c1", 1, ATTEMPTS),
                           ("seal_c20_large", N_CLIENTS, LARGE_ATTEMPTS)):
            out[f"{name}_ms"] = cs.kernel_ms(
                torch, lambda c=c, n=n: pow_ops.mine_seal(
                    prev, digest, c, n, nonce_offset=off,
                    difficulty_bits=DIFFICULTY),
                f"{tag} mine_seal C={c} n={n}", reps=50)
        # the tile at the paper's budget: one block a client (10240), or
        # several and the ticket
        for chunk in CHUNK_SWEEP:
            out[f"flat_chunk{chunk}_ms"] = cs.kernel_ms(
                torch, lambda chunk=chunk: pow_ops.pow_race_flat(
                    prev, payloads, off, ATTEMPTS, chunk=chunk),
                f"{tag} pow_race_flat C=20 chunk={chunk}", reps=50)
            out[f"seal_chunk{chunk}_ms"] = cs.kernel_ms(
                torch, lambda chunk=chunk: pow_ops.mine_seal(
                    prev, digest, N_CLIENTS, ATTEMPTS, nonce_offset=off,
                    difficulty_bits=DIFFICULTY, chunk=chunk),
                f"{tag} mine_seal C=20 chunk={chunk}", reps=50)
        # budgets of several blocks a client
        for c, n in LARGE_CASES:
            pay = payloads[:c].contiguous()
            out[f"flat_c{c}_n{n}_ms"] = cs.kernel_ms(
                torch, lambda pay=pay, n=n: pow_ops.pow_race_flat(
                    prev, pay, off, n),
                f"{tag} pow_race_flat C={c} n={n}", reps=20)
        # empty launches of the race's shapes: what a launch of that many
        # threads costs with no work
        for blocks, threads in EMPTY_SHAPES:
            out[f"empty_{blocks}x{threads}_ms"] = cs.kernel_ms(
                torch, cs.empty_launch(torch, blocks, threads),
                f"{tag} empty launch {blocks}x{threads}", reps=50)
    out.update(rounds_of_paper_path(torch, cs, dev))
    out["readings"] = cs.READINGS
    print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
