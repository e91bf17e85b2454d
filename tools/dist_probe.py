#!/usr/bin/env python3
"""What ``torch.distributed`` does with CUDA tensors on this machine: the
facts ``launch/mesh.py`` is built on, read on the card.

Run on a machine with a CUDA GPU:

    python3 tools/dist_probe.py

Each check runs in a world of its own (a rank that aborts takes only its
world down) and prints one JSON line:

  * ``gloo`` at 2 ranks, one card: each collective the engine uses
    (``all_gather_into_tensor``, ``all_reduce``, ``broadcast``,
    ``batch_isend_irecv``) on CUDA tensors: its result, or how it failed
    (``launch/mesh.py`` stages the ops that fail through pinned host
    buffers: ``GLOO_CUDA_STAGED``);
  * ``nccl`` at 2 ranks on one card: its error (NCCL refuses two ranks on
    one device, which is why ``mesh.check_backend`` does);
  * ``nccl`` at 1 rank: an all-gather and an all-reduce captured in a CUDA
    graph and replayed on new inputs, as the graph driver captures them.

The first lines are the versions and the card's name and power limit.
Exits 1 without a GPU.
"""
from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import tempfile
import time
import traceback

N = 2
TIMEOUT_S = 120.0


def _op(name, rank, n, dev):
    import torch
    import torch.distributed as dist

    x = torch.full((3, 2), float(rank + 1), device=dev)
    if name == "all_gather_into_tensor":
        out = torch.empty((3 * n, 2), device=dev)
        dist.all_gather_into_tensor(out, x)
        return out[:, 0].tolist()
    if name == "all_reduce":
        dist.all_reduce(x)
        return x[0, 0].item()
    if name == "broadcast":
        dist.broadcast(x, 0)
        return x[0, 0].item()
    if name == "batch_isend_irecv":
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % n),
               dist.P2POp(dist.irecv, got, (rank - 1) % n)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got[0, 0].item()
    if name == "graph":
        x = torch.ones(1024, device=dev)
        out = torch.empty(1024 * n, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dist.all_gather_into_tensor(out, x)   # the communicator
            dist.all_reduce(x)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            y = x * 2
            dist.all_gather_into_tensor(out, y)
            dist.all_reduce(y)
            graph.capture_end()
            x.fill_(3.0)
            graph.replay()
            torch.cuda.synchronize()
        return {"gathered": out[:2].tolist(), "reduced": y[:2].tolist(),
                "want": 6.0 * n}
    raise ValueError(name)


def _rank(name, rank, n, backend, init, results):
    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=n)
        out = _op(name, rank, n, torch.device("cuda", 0))
        results.put((rank, "ok", out))
        dist.destroy_process_group()
    except Exception as err:   # reported as the check's result
        results.put((rank, "error", f"{type(err).__name__}: "
                     + str(err).strip().splitlines()[-1][:300]))
        traceback.print_exc()


def check(name, n, backend):
    """One world of ``n`` ``backend`` ranks on card 0 running ``name``:
    each rank's result or error, and each process's exit code."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, daemon=True,
                             args=(name, r, n, backend, init, results))
                 for r in range(n)]
        t0 = time.monotonic()
        for p in procs:
            p.start()
        got = {}
        while len(got) < n and time.monotonic() - t0 < TIMEOUT_S:
            try:
                rank, status, out = results.get(timeout=0.5)
                got[rank] = [status, out]
            except queue.Empty:
                if all(p.exitcode is not None for p in procs):
                    break
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return {"check": name, "backend": backend, "ranks": n,
            "results": {str(r): got.get(r, ["no result", None])
                        for r in range(n)},
            "exit_codes": [p.exitcode for p in procs],
            "seconds": round(time.monotonic() - t0, 1)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    for name in ("all_gather_into_tensor", "all_reduce", "broadcast",
                 "batch_isend_irecv"):
        print(json.dumps(check(name, N, "gloo")), flush=True)
    print(json.dumps(check("all_reduce", N, "nccl")), flush=True)
    print(json.dumps(check("graph", 1, "nccl")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
