#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py                  # build, check, run, compare
    python3 chip_smoke.py --profile DIR    # also profile the rounds into DIR

It builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(one ``nvcc`` per source, all at once), sets fp32 matmuls to full
precision, and runs three phases, each of which raises on failure:

1. every kernel against its plain PyTorch version on the card, at the
   shapes of the main path (the race bitwise, the float kernels to a
   stated tolerance), with its time, the plain version's time, the time of
   one PyTorch call computing the same function where there is one, and
   its bound on an H100;
2. the main path, ``repro_torch.launch.train`` at the paper's full
   configuration (C = 20, MLP 784-256-10, 512 samples per client, K = 5,
   tau = 10, 2 lazy clients, sigma2 = 0.01, 10240 mining attempts,
   difficulty 4), with every kernel's launch count read around that run;
3. the same run on the CPU (plain versions), held against the card's.

The last three lines of its output are the kernel table as JSON, the
card's name and power limit, and ``{"ok": true, "device": ...}``. It
exits non-zero, and prints no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s; fp32 outside the
# tensor cores, also used for 32-bit integer ALU work (an upper bound on
# that rate, so the bound stays a lower bound on time)
PEAK_BYTES_S = 3.35e12
PEAK_ALU_OPS_S = 67e12

# the paper's configuration (launch/train.py flags)
K = 5
MAIN_ARGS = ["--arch", "mlp", "--k", str(K), "--clients", "20", "--lazy", "2",
             "--sigma2", "0.01", "--t-sum", "100", "--alpha", "1",
             "--beta", "10", "--eta", "0.05", "--seed", "0"]
N_CLIENTS = 20
LEAF_WIDTHS = {"b1": 256, "b2": 10, "w1": 784 * 256, "w2": 256 * 10}
MINE_ATTEMPTS, MINE_CHUNK = 10240, 1024
# ops of one hash in the race: avalanche (3 shifts, 3 xors, 2 muls), the
# nonce add and xor, and the compare/select of the running minimum
OPS_PER_HASH = 12

# tolerances: float kernels sum in another order than the plain versions
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6      # mix and residuals
LEAF_SUM_REL = 1e-5                       # |d leaf sum| <= this * sum|x|
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-4, 1e-5  # a whole run, card vs CPU

REPLACES = {
    "pow_race": "src/repro/kernels/pow_hash/kernel.py:128 pow_race_kernel "
                "(and :65 pow_search_kernel, its C = 1 case)",
    "fedavg_flat": "src/repro/kernels/fedavg/kernel.py:32 fedavg_flat",
    "digest_div_flat": "src/repro/kernels/fedavg/kernel.py:127 "
                       "digest_div_flat",
}
# kernel -> the shared library (kernels/_build.py SOURCES) that holds it
LIBRARY = {"pow_race": "pow_race", "fedavg_flat": "fedavg",
           "digest_div_flat": "fedavg"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, reps=50, warmup=5):
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after a warm-up: the call's throughput, host overhead
    included when it exceeds the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(torch, prof):
    """Total duration of the GPU activities (kernels, memsets, copies) a
    torch.profiler run recorded, in microseconds."""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def kernel_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: the GPU activity torch.profiler
    records over ``reps`` calls, over ``reps``. Falls back to CUDA events
    over back-to-back calls if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = device_us(torch, prof)
    if us <= 0:
        print("kernel_ms: profiler saw no device time; timing with CUDA "
              "events instead", flush=True)
        return time_ms(torch, fn, reps)
    return us / 1e3 / reps


def phase_kernels(torch, dev):
    """Phase 1: each kernel against its plain version, and its times."""
    from repro_torch.core import mining
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.pow_hash import ops as pow_ops
    from repro_torch.kernels.pow_hash import ref as pow_ref

    gen = torch.Generator().manual_seed(1234)
    report = {}

    def word(v):
        return torch.full((), int(v) & mining.MASK, dtype=torch.int64,
                          device=dev)

    # --- pow_race: bitwise, at the main path's budget and at tails -------
    cases = [(N_CLIENTS, MINE_ATTEMPTS, MINE_CHUNK), (N_CLIENTS, 3000, 1024),
             (N_CLIENTS, 1000, 384), (1, MINE_ATTEMPTS, MINE_CHUNK),
             (7, 4097, 256)]
    offsets = [4 << 20, 0xFFFFFFFF - 500]   # the second wraps past 2**32
    for c, n, chunk in cases:
        for off in offsets:
            payloads = torch.randint(0, 2 ** 32, (c,), generator=gen,
                                     dtype=torch.int64).to(dev)
            prev = word(torch.randint(0, 2 ** 32, (), generator=gen))
            h, nn = pow_ops.pow_race_flat(prev, payloads, word(off), n,
                                          chunk=chunk)
            rh, rn = pow_ref.pow_race_ref(prev, word(off), payloads, n)
            require(torch.equal(h, rh) and torch.equal(nn, rn),
                    f"pow_race differs from its plain version at C={c} "
                    f"n={n} chunk={chunk} off={off}")
    # the salting wrapper at C = 1 is the single-client search
    h1, n1 = pow_ops.mine(word(7), word(0xCAFE), word(3), 2500,
                          nonce_offset=word(1 << 20))
    rh1, rn1 = mining.pow_search(7, 0xCAFE, 3, 2500, nonce_offset=1 << 20)
    require(int(h1) == int(rh1) and int(n1) == int(rn1),
            "single-client mine differs from mining.pow_search")
    payloads = torch.randint(0, 2 ** 32, (N_CLIENTS,), generator=gen,
                             dtype=torch.int64).to(dev)
    prev, off = word(99), word(4 << 20)
    hashes = N_CLIENTS * MINE_ATTEMPTS
    in_out_bytes = 8 * (N_CLIENTS + 2) + 16 * N_CLIENTS

    def race():
        return pow_ops.pow_race_flat(prev, payloads, off, MINE_ATTEMPTS,
                                     chunk=MINE_CHUNK)

    report["pow_race"] = dict(
        max_abs_err=0,
        ms=kernel_ms(torch, race), call_ms=time_ms(torch, race),
        plain_ms=kernel_ms(torch, lambda: pow_ref.pow_race_ref(
            prev, off, payloads, MINE_ATTEMPTS)),
        library_ms=None,
        bound_ms=1e3 * max(in_out_bytes / PEAK_BYTES_S,
                           hashes * OPS_PER_HASH / PEAK_ALU_OPS_S),
        bound_by="operations")

    # --- fedavg_flat and digest_div_flat at each leaf width ---------------
    fed_err = dig_err = 0.0
    for name, n in LEAF_WIDTHS.items():
        x = torch.randn((N_CLIENTS, n), generator=gen).to(dev) + 0.25
        noise = 0.1 * torch.randn((N_CLIENTS, n), generator=gen).to(dev)
        uniform = torch.full((N_CLIENTS,), 1.0 / N_CLIENTS, device=dev)
        w = torch.rand(N_CLIENTS, generator=gen).to(dev) + 0.5
        for weights in (uniform, (w / w.sum()).contiguous()):
            for nz in (None, noise):
                got = fedavg_ops.fedavg_flat(x, weights, nz)
                want = fedavg_ref.fedavg_flat_ref(x, weights, nz)
                err = (got - want).abs()
                fed_err = max(fed_err, float(err.max()))
                require(bool((err <= FLOAT_ATOL + FLOAT_RTOL
                              * want.abs()).all()),
                        f"fedavg_flat off tolerance on leaf {name}")
        s, r = fedavg_ops.digest_div_flat(x)
        s2, r2 = fedavg_ops.digest_div_flat(x)
        require(torch.equal(s, s2) and torch.equal(r, r2),
                f"digest_div_flat not deterministic on leaf {name}")
        rs, rr = fedavg_ref.digest_div_flat_ref(x)
        abs_sum = float(x.abs().sum())
        require(abs(float(s) - float(rs)) <= LEAF_SUM_REL * abs_sum,
                f"digest_div_flat leaf sum off on leaf {name}: "
                f"{float(s)} vs {float(rs)}")
        rerr = (r - rr).abs()
        require(bool((rerr <= FLOAT_RTOL * rr.abs()).all()),
                f"digest_div_flat residuals off tolerance on leaf {name}")
        dig_err = max(dig_err, abs(float(s) - float(rs)), float(rerr.max()))

    leaves = {name: torch.randn((N_CLIENTS, n), generator=gen).to(dev)
              for name, n in LEAF_WIDTHS.items()}
    uniform = torch.full((N_CLIENTS,), 1.0 / N_CLIENTS, device=dev)
    w_rows = uniform.expand(N_CLIENTS, N_CLIENTS).contiguous()
    elems = N_CLIENTS * sum(LEAF_WIDTHS.values())

    def per_round(fn):
        # one round calls each kernel once per leaf: time the four calls
        return lambda: [fn(x) for x in leaves.values()]

    mix = per_round(lambda x: fedavg_ops.fedavg_flat(x, uniform))
    report["fedavg_flat"] = dict(
        max_abs_err=fed_err,
        ms=kernel_ms(torch, mix), call_ms=time_ms(torch, mix),
        plain_ms=kernel_ms(torch, per_round(
            lambda x: fedavg_ref.fedavg_flat_ref(x, uniform))),
        # one PyTorch call, same function: the mean-row matrix times x
        library_ms=kernel_ms(torch, per_round(lambda x: torch.mm(w_rows, x))),
        bound_ms=1e3 * max((8 * elems + 16 * N_CLIENTS) / PEAK_BYTES_S,
                           2 * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")
    sweep = per_round(fedavg_ops.digest_div_flat)
    report["digest_div_flat"] = dict(
        max_abs_err=dig_err,
        ms=kernel_ms(torch, sweep), call_ms=time_ms(torch, sweep),
        plain_ms=kernel_ms(torch, per_round(fedavg_ref.digest_div_flat_ref)),
        library_ms=None,
        bound_ms=1e3 * max((4 * elems + 4 * 4 * (N_CLIENTS + 1))
                           / PEAK_BYTES_S, 4 * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")
    print(f"phase 1 ok: pow_race bitwise on {len(cases) * len(offsets)} "
          f"budgets; largest deviation fedavg_flat {fed_err:.3g} "
          f"(rtol {FLOAT_RTOL}, atol {FLOAT_ATOL}), digest_div_flat "
          f"{dig_err:.3g} (leaf sum {LEAF_SUM_REL} of sum|x|, residuals "
          f"rtol {FLOAT_RTOL})", flush=True)
    return report


def phase_main_path(torch, dev):
    """Phase 2: the paper's run on the card, through the kernels."""
    from repro_torch import kernels
    from repro_torch.launch import train

    args = train.build_parser().parse_args(MAIN_ARGS + ["--device", str(dev)])
    kernels.reset_launch_counts()
    result, state, hist = train.train_mlp(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {"pow_race": K, "fedavg_flat": 4 * K, "digest_div_flat": 4 * K}
    require(launches == want,
            f"launch counts {launches} on the main path, expected {want}")
    require(result["chain_valid"] and result["blocks"] == K,
            f"ledger not valid: {result}")
    require(result["tau"] == 10, f"tau {result['tau']} != 10")
    for h in hist:
        require(all(math.isfinite(h[k]) for k in
                    ("local_loss_mean", "global_loss", "divergence")),
                f"non-finite metrics {h}")
    require(hist[-1]["global_loss"] < hist[0]["global_loss"],
            "global loss did not fall: "
            f"{[h['global_loss'] for h in hist]}")
    require(all(math.isfinite(v.float().abs().sum().item())
                for v in state.params.values()), "non-finite params")
    syncs = round_host_syncs(torch, args)
    require(not syncs, f"{len(syncs)} host syncs inside the rounds: "
                       f"{syncs[:3]}")
    print("phase 2 ok: " + json.dumps(
        {"launches": launches, "global_loss": [h["global_loss"]
                                               for h in hist],
         "final_eval_acc": result["final_eval_acc"],
         "host_syncs_in_rounds": len(syncs),
         "wall_s_first_run": result["wall_s"]}), flush=True)
    return args, result, state, hist, launches


def round_host_syncs(torch, args):
    """Run the main path's K rounds (no end-of-run transfer) with CUDA's
    sync debug mode on and return the warnings of the host syncs they make.
    The design makes none: the carry, the metrics and every input of the
    race stay on the device."""
    import warnings

    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    state = rounds.init_state({k: v.to(dev) for k, v in params.items()},
                              spec.n_clients,
                              torch.Generator().manual_seed(blade.seed + 2))
    round_fn = rounds.make_integrated_round(mlp_client_losses, spec,
                                            n_rounds=blade.K)
    batch = src.static_batch()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(blade.K):
                state, _ = round_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def round_ms(torch, args, profile_dir):
    """ms per round of a warm run of the main path: the trainer's host-clock
    ``wall_s`` (K rounds ending in the one host transfer, the ledger and
    the final eval) over K. With ``profile_dir``, also profile the K-round
    loop alone and report the device's busy share of it."""
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    result, _, _ = train.train_mlp(args)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile as prof
        blade, spec, src, params, dev = train.prepare_mlp(args)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            rounds.run_blade_fl(mlp_client_losses, spec, params,
                                src.static_batch(), blade.K,
                                seed=blade.seed + 2, device=dev)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_ms = device_us(torch, p) / 1e3
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "profile_rounds.txt")
        with open(path, "w") as f:
            for key in ("cuda_time_total", "cpu_time_total"):
                f.write(p.key_averages().table(sort_by=key, row_limit=40))
                f.write("\n")
        print(f"profile: K = {blade.K} rounds in {wall_ms:.3f} ms (host "
              f"clock, under the profiler); device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %); tables in "
              f"{path}", flush=True)
    return 1e3 * result["wall_s"] / K


def phase_card_vs_cpu(torch, args, state, hist):
    """Phase 3: the same run on the CPU (plain versions) against the
    card's."""
    from repro_torch.launch import train

    cpu_args = argparse.Namespace(**{**vars(args), "device": "cpu"})
    _, cpu_state, cpu_hist = train.train_mlp(cpu_args)
    worst = 0.0
    for k, (a, b) in enumerate(zip(hist, cpu_hist)):
        for key in ("local_loss_mean", "global_loss", "divergence"):
            dev_ = abs(a[key] - b[key])
            worst = max(worst, dev_ / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                       * abs(b[key])))
            require(dev_ <= CARD_CPU_ATOL + CARD_CPU_RTOL * abs(b[key]),
                    f"round {k} {key}: card {a[key]} vs cpu {b[key]}")
    for name, v in state.params.items():
        a, b = v.cpu(), cpu_state.params[name]
        excess = ((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL * b.abs()))
        worst = max(worst, float(excess.max()))
        require(bool((excess <= 1).all()),
                f"final {name} differs between card and cpu beyond "
                f"rtol {CARD_CPU_RTOL} atol {CARD_CPU_ATOL}")
    print(f"phase 3 ok: card vs cpu over {K} rounds within rtol "
          f"{CARD_CPU_RTOL} atol {CARD_CPU_ATOL}; worst |diff|/tol "
          f"{worst:.3g}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one warm run of the main path's "
                         "rounds and write the tables into DIR")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    report = phase_kernels(torch, dev)
    args, result, state, hist, launches = phase_main_path(torch, dev)
    ms_round = round_ms(torch, args, opts.profile)
    print(f"round time: {ms_round:.3f} ms per round (host clock, warm run "
          f"of K = {K} at C = {N_CLIENTS})", flush=True)
    phase_card_vs_cpu(torch, args, state, hist)

    table = [{"name": name, "route": "cuda",
              "source": os.path.relpath(_build.SOURCES[LIBRARY[name]], ROOT),
              "replaces": REPLACES[name], "launches": launches[name],
              **report[name]} for name in ("pow_race", "fedavg_flat",
                                           "digest_div_flat")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
