#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py                  # build, check, run, compare
    python3 chip_smoke.py --profile DIR    # also profile rounds and a prefill

It builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(one ``nvcc`` per source, all at once), sets fp32 matmuls to full
precision, and runs these phases, each of which raises on failure and
prints its seconds:

1. every FL kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (the race bitwise, the float kernels to a
   stated tolerance; ``mix_rows_flat`` bitwise, also at ragged widths and
   on misaligned views, where its float4 path cannot run;
   ``digest_div_flat`` three calls bitwise equal at every leaf, every leaf
   as an offset view, and C in DIGEST_CLIENTS x N in DIGEST_WIDTHS), with
   its time, the plain version's time, the time of one PyTorch call
   computing the same function where there is one, and its bound on an
   H100; the race's
   C = 1 case (one ``ops.mine`` call) is timed too;
1b. the same for the serve path's kernels, ``flash_attention`` (at the
   path's attention shape, the reference's test shapes, ragged S, head
   dims 36 / 112 / 256, a window, a bidirectional mask, GQA, bf16, and
   fp32 views too misaligned for its cp.async staging) and
   ``ssm_scan`` (the path's Mamba shape, the reference's test shapes,
   ragged T and d_in, ds at its state-bucket edges, T at its chunk edges,
   d_in off its channel block, offset views);
2. the paper's path, ``repro_torch.launch.train`` at the paper's full
   configuration (C = 20, MLP 784-256-10, 512 samples per client, K = 5,
   tau = 10, 2 lazy clients, sigma2 = 0.01, 10240 mining attempts,
   difficulty 4), with every kernel's launch count read around that run
   and no host sync inside its rounds;
2b. the topology path: the same configuration with ``--topology
   random:0.5 --fused-mix`` (per-round link dropout, the dense mix on the
   ``mix_rows_flat`` kernel), checked the same way;
2c. the adversarial paths at K = 2: ``--attack alie --attackers 2
   --robust median`` and ``--topology snr --fused-mix --attack signflip``;
3. and 3b. the runs of phases 2 and 2b on the CPU (plain versions), held
   against the card's; 3c. the same for ``--topology ring``, a
   non-consensus mix that runs no custom kernel. Per-client params of the
   non-consensus paths are held to ``CLIENT_SPREAD_LIMIT`` times the
   tolerance, a limit a planted one-row fault is shown to break;
4. the serve path, ``repro_torch.launch.serve --arch jamba-1.5-large-398b
   --size one-h100 --batch 4 --prompt-len 2048 --gen 32`` (Jamba at its
   published widths, 8 layers, dense MLPs: 9.0 G parameters): one prefill
   launches ``flash_attention`` once and ``ssm_scan`` 7 times, decode no
   kernel; then the phi4-mini smoke config (2 flash launches);
4b. on the same full-width params, prefill + 8 decode steps against one
   forward over 2056 tokens, and 256 decode steps from an empty state
   against the forward, in max |logit diff| <= ``AGREE_LIMIT``, and no
   host sync in the decode loop.

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
# that rate, so the bound stays a lower bound on time); TF32 on the tensor
# cores
PEAK_BYTES_S = 3.35e12
PEAK_ALU_OPS_S = 67e12
PEAK_TF32_S = 495e12
# the flash kernel runs each product as three TF32 passes (3xTF32), the
# least that holds fp32's tolerance on the tensor cores
FLASH_TF32_PASSES = 3

# the paper's configuration (launch/train.py flags)
K = 5
MAIN_ARGS = ["--arch", "mlp", "--k", str(K), "--clients", "20", "--lazy", "2",
             "--sigma2", "0.01", "--t-sum", "100", "--alpha", "1",
             "--beta", "10", "--eta", "0.05", "--seed", "0"]
# the topology path: per-round link dropout mixed by the mix_rows_flat kernel
TOPOLOGY_ARGS = MAIN_ARGS + ["--topology", "random:0.5", "--fused-mix"]
# a non-consensus path whose mix runs no custom kernel (phase 3c)
RING_ARGS = MAIN_ARGS + ["--topology", "ring"]
# the adversarial paths, at a smaller depth
K_ADV = 2
ADVERSARIAL_ARGS = [
    ["--attack", "alie", "--attackers", "2", "--robust", "median"],
    ["--topology", "snr", "--fused-mix", "--attack", "signflip"],
]
N_CLIENTS = 20
LEAF_WIDTHS = {"b1": 256, "b2": 10, "w1": 784 * 256, "w2": 256 * 10}
MINE_ATTEMPTS, MINE_CHUNK = 10240, 1024
# ops of one hash in the race: avalanche (3 shifts, 3 xors, 2 muls), the
# nonce add and xor, and the compare/select of the running minimum
OPS_PER_HASH = 12

# digest_div_flat beyond the leaves: client counts either side of its
# register form's largest bucket (32; above it the slab form) and widths
# with ragged float4 tails, each held at every pair
DIGEST_CLIENTS = [1, 7, 20, 32, 33, 64, 100]
DIGEST_WIDTHS = [1, 3, 10, 1023, 1025, 784 * 256 + 1]
# (C, N) with C above the slab form's fit (12 031), which reads x twice
DIGEST_HUGE_C = [(12100, 1025)]
DIGEST_CALLS = 3   # calls per case that must give the same bits

# tolerances: float kernels sum in another order than the plain versions
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6      # mix and residuals
LEAF_SUM_REL = 1e-5                       # |d leaf sum| <= this * sum|x|
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-4, 1e-5  # a whole run, card vs CPU
# Per-client params of a path without consensus, card vs CPU: the largest
# |diff| / (atol + rtol |cpu|) allowed. On an H100 (700 W) the topology
# path reads 1.98 and the ring path 3.35 (the last bits of cuBLAS's and the
# CPU's local-training GEMMs, grown along each client's own trajectory);
# a client that takes 1 % of another's model reads 25-100.
CLIENT_SPREAD_LIMIT = 10.0
# the planted fault the limit is held against: client 0 adopts this share
# of client 1's model
PLANTED_LEAK = 0.01

# the serve path (phase 4): Jamba-1.5-Large at its published widths cut to
# one H100 (configs/jamba_1_5_large_398b.py ONE_H100), a 2048-token prompt
SERVE_ARGS = ["--arch", "jamba-1.5-large-398b", "--size", "one-h100",
              "--batch", "4", "--prompt-len", "2048", "--gen", "32"]
SERVE_SMOKE_ARGS = ["--arch", "phi4-mini-3.8b", "--size", "smoke"]
SERVE_LAUNCHES = {"flash_attention": 1, "ssm_scan": 7}   # one prefill
SERVE_SMOKE_LAUNCHES = {"flash_attention": 2, "ssm_scan": 0}
# phase 4b: (i) prefill of the first AGREE_PREFILL prompt tokens and
# AGREE_STEPS teacher-forced decode steps against one forward over all of
# them; (ii) AGREE_DECODE_LEN tokens decoded one by one from an empty state
# against the forward over them. Logits are of unit scale at this init.
AGREE_PREFILL, AGREE_STEPS, AGREE_DECODE_LEN = 2048, 8, 256
AGREE_LIMIT = 1e-3
SYNC_CHECK_STEPS = 4   # greedy decode steps run in CUDA's sync-debug mode
# the flash kernel at the serve path's attention shape: B, H, Hkv, S, D
FLASH_PATH = (4, 64, 8, 2048, 128)
# (B, H, Hkv, S, D, causal, window, bf16): the path shape; the reference's
# FLASH_CASES (tests/test_kernels.py); ragged S; the zoo's odd head dims
# (minicpm 36, kimi 112) and the largest (256); a window; a ragged
# bidirectional mask; GQA throughout; bf16 at a small and the path shape
FLASH_CASES = [
    FLASH_PATH + (True, 0, False),
    (2, 4, 4, 256, 64, True, 0, False), (1, 2, 2, 128, 32, False, 0, False),
    (2, 2, 2, 256, 64, True, 64, False), (1, 1, 1, 512, 128, True, 0, False),
    (1, 2, 2, 128, 16, True, 32, False),
    (1, 8, 2, 1000, 128, True, 0, False), (1, 8, 2, 2056, 128, True, 0, False),
    (2, 4, 2, 300, 36, True, 0, False), (2, 4, 2, 300, 112, True, 0, False),
    (1, 4, 1, 300, 256, True, 0, False),
    (2, 4, 4, 1000, 64, True, 128, False), (2, 4, 2, 777, 64, False, 0, False),
    (1, 2, 2, 128, 64, True, 0, True), FLASH_PATH + (True, 0, True),
]
# fp32 cases whose q, k, v the kernel cannot stage with 16-byte cp.async,
# so it loads them with plain loads: (B, H, Hkv, S, D, causal, window, how)
# with ``how`` "offset" (each tensor a view starting one float past an
# aligned address) or "rows" (rows of D + 1 floats, read through a [..., :D]
# view: no row starts 16-byte aligned)
FLASH_MISALIGNED = [(1, 8, 2, 300, 128, True, 0, "offset"),
                    (2, 4, 2, 300, 36, True, 0, "offset"),
                    (2, 4, 2, 257, 64, True, 64, "rows")]
FLASH_RTOL = FLASH_ATOL = 3e-5   # fp32, as the JAX tests hold the TPU kernel
# bf16 is held to the fp32 plain result on the same bf16 inputs: the
# kernel's one bf16 rounding of its fp32 output is at most 2^-9 of |want|
FLASH_BF16_ATOL, FLASH_BF16_RTOL = 2e-3, 1e-2
# the scan at the serve path's Mamba shape: B, T, d_in, d_state
SSM_PATH = (4, 2048, 16384, 16)
# the path shape; the reference's SSM_CASES; ragged T and d_in; a d_state
# below the smallest template bucket and the largest taken
SSM_CASES = [SSM_PATH, (2, 64, 128, 16), (1, 128, 256, 8), (2, 32, 64, 4),
             (1, 16, 32, 16), (2, 37, 100, 16), (1, 5, 130, 3),
             (3, 1000, 1000, 64)]
SSM_ATOL, SSM_RTOL = 2e-5, 1e-5


def ssm_edge_cases(chunk):
    """(B, T, d_in, ds) at the kernel's edges: ds either side of its state
    buckets (1, 5, 9, 17, 33), d_in not a multiple of its 64-channel block
    (130, 200, 16383; 130 and 16383 not of 4 either, which takes its
    4-byte copies), T of 1, 2049 and either side of its ``chunk``-step
    stage."""
    return [(1, 1, 64, 16), (2, chunk - 1, 130, 1), (2, chunk + 1, 16383, 5),
            (1, 2049, 256, 9), (2, 33, 200, 17), (1, 100, 130, 33),
            (2, 64, 16383, 16)]


# cases whose every input is a view one float past an aligned address, so
# the kernel stages them with 4-byte copies: (B, T, d_in, ds)
SSM_MISALIGNED = [(2, 40, 256, 16), (1, 33, 100, 12)]
# the H100 SXM's special-function rate for exp2 (CUDA C Programming Guide,
# arithmetic throughput of compute capability 9.0: 16 per clock per SM) at
# its 1.98 GHz boost clock on 132 SMs
PEAK_EXP_S = 16 * 132 * 1.98e9

REPLACES = {
    "pow_race": "src/repro/kernels/pow_hash/kernel.py:128 pow_race_kernel "
                "(and :65 pow_search_kernel, its C = 1 case)",
    "fedavg_flat": "src/repro/kernels/fedavg/kernel.py:32 fedavg_flat",
    "digest_div_flat": "src/repro/kernels/fedavg/kernel.py:127 "
                       "digest_div_flat",
    "mix_rows_flat": "src/repro/kernels/fedavg/kernel.py:73 mix_rows_flat",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:82 "
                       "flash_attention",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:49 ssm_scan",
}
# kernel -> the shared library (kernels/_build.py SOURCES) that holds it
LIBRARY = {"pow_race": "pow_race", "fedavg_flat": "fedavg",
           "digest_div_flat": "fedavg", "mix_rows_flat": "fedavg",
           "flash_attention": "flash_attention", "ssm_scan": "ssm_scan"}
# kernel -> the path whose run gives its launch count in the table
MAIN_PATH_OF = {"pow_race": "paper", "fedavg_flat": "paper",
                "digest_div_flat": "paper", "mix_rows_flat": "topology",
                "flash_attention": "serve", "ssm_scan": "serve"}
# the (R, K) blocks mix_rows_flat is held to its plain version at: the
# main path's full W, a row block, a column block, the largest it takes
MIX_BLOCKS = [(N_CLIENTS, N_CLIENTS), (5, N_CLIENTS), (N_CLIENTS, 5),
              (64, 64)]
# widths where the kernel's float4 path cannot run: N = 1, 2, 3 (mod 4), the
# first at the widest leaf's width; each is also held on a contiguous view
# whose storage starts one float past an aligned address, as is every leaf
MIX_RAGGED = [784 * 256 + 1, 2050, 7]


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


def check_digest(torch, x, what):
    """``digest_div_flat`` on x [C, N]: DIGEST_CALLS calls give the same
    bits; the leaf sum within LEAF_SUM_REL of sum |x| and the residuals
    within rtol FLOAT_RTOL of the plain version. Returns the largest
    deviation."""
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref

    s, r = fedavg_ops.digest_div_flat(x)
    for _ in range(DIGEST_CALLS - 1):
        s2, r2 = fedavg_ops.digest_div_flat(x)
        require(torch.equal(s, s2) and torch.equal(r, r2),
                f"digest_div_flat not deterministic on {what}")
    rs, rr = fedavg_ref.digest_div_flat_ref(x)
    abs_sum = float(x.abs().sum())
    require(abs(float(s) - float(rs)) <= LEAF_SUM_REL * abs_sum,
            f"digest_div_flat leaf sum off on {what}: {float(s)} vs "
            f"{float(rs)}")
    rerr = (r - rr).abs()
    require(bool((rerr <= FLOAT_RTOL * rr.abs()).all()),
            f"digest_div_flat residuals off tolerance on {what}: max "
            f"|diff| {float(rerr.max()):.3g}")
    return max(abs(float(s) - float(rs)), float(rerr.max()))


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

    # the C = 1 case (the JAX package's pow_search_kernel): the launch one
    # ops.mine call of MINE_ATTEMPTS makes, on the payload it salts
    salted = (word(0xCAFE) ^ mining.client_salt(word(3))).reshape(1)
    salted = salted.contiguous()
    h1, n1 = pow_ops.mine(word(99), word(0xCAFE), word(3), MINE_ATTEMPTS,
                          nonce_offset=off)
    rh1, rn1 = pow_ref.pow_race_ref(prev, off, salted, MINE_ATTEMPTS)
    require(int(h1) == int(rh1[0]) and int(n1) == int(rn1[0]),
            "mine at the main path's budget differs from its plain version")

    def race_one():
        return pow_ops.pow_race_flat(prev, salted, off, MINE_ATTEMPTS,
                                     chunk=MINE_CHUNK)

    report["pow_race"] = dict(
        max_abs_err=0,
        ms=kernel_ms(torch, race), call_ms=time_ms(torch, race),
        plain_ms=kernel_ms(torch, lambda: pow_ref.pow_race_ref(
            prev, off, payloads, MINE_ATTEMPTS)),
        library_ms=None,
        bound_ms=1e3 * max(in_out_bytes / PEAK_BYTES_S,
                           hashes * OPS_PER_HASH / PEAK_ALU_OPS_S),
        bound_by="operations",
        c1=dict(ms=kernel_ms(torch, race_one),
                plain_ms=kernel_ms(torch, lambda: pow_ref.pow_race_ref(
                    prev, off, salted, MINE_ATTEMPTS)),
                bound_ms=1e3 * max((8 * (1 + 2) + 16) / PEAK_BYTES_S,
                                   MINE_ATTEMPTS * OPS_PER_HASH
                                   / PEAK_ALU_OPS_S),
                bound_by="operations"))

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
        dig_err = max(dig_err, check_digest(torch, x, f"leaf {name}"))
    # every leaf width as a view one float past an aligned address (the
    # scalar-load form), then the client counts and widths of the domain
    dgen = torch.Generator(device=dev).manual_seed(2468)
    digest_cases = 0
    for name, n in LEAF_WIDTHS.items():
        buf = torch.randn(N_CLIENTS * n + 1, generator=dgen, device=dev)
        x = buf[1:].view(N_CLIENTS, n).add_(0.25)
        require(x.data_ptr() % 16 != 0, f"digest case setup: leaf {name}")
        dig_err = max(dig_err, check_digest(torch, x, f"leaf {name} "
                                                       "(offset view)"))
        digest_cases += 1
    for c, n in ([(c, n) for c in DIGEST_CLIENTS for n in DIGEST_WIDTHS]
                 + DIGEST_HUGE_C):
        x = torch.randn((c, n), generator=dgen, device=dev) + 0.25
        dig_err = max(dig_err, check_digest(torch, x, f"C={c} N={n}"))
        digest_cases += 1

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
        # each leaf's call alone: the narrow ones are one-block launches
        per_leaf_ms={name: kernel_ms(torch, lambda x=x:
                                     fedavg_ops.digest_div_flat(x))
                     for name, x in leaves.items()},
        bound_ms=1e3 * max((4 * elems + 4 * 4 * (N_CLIENTS + 1))
                           / PEAK_BYTES_S, 4 * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")

    # --- mix_rows_flat at each leaf width and block shape -----------------
    mix_err = 0.0
    for name, n in LEAF_WIDTHS.items():
        for r, k in MIX_BLOCKS:
            x = torch.randn((k, n), generator=gen).to(dev)
            w = torch.rand((r, k), generator=gen) + 0.1
            w = (w / w.sum(dim=1, keepdim=True)).to(dev)
            got = fedavg_ops.mix_rows_flat(w, x)
            want = fedavg_ref.mix_rows_flat_ref(w, x)
            err = (got - want).abs()
            mix_err = max(mix_err, float(err.max()))
            require(bool((err <= FLOAT_ATOL + FLOAT_RTOL
                          * want.abs()).all()),
                    f"mix_rows_flat off tolerance on leaf {name} at "
                    f"R={r} K={k}")
            require(torch.equal(got, want),
                    f"mix_rows_flat not bitwise equal to its plain version "
                    f"on leaf {name} at R={r} K={k}")
    # the scalar form of the kernel: ragged widths, and misaligned views
    dgen = torch.Generator(device=dev).manual_seed(5678)
    mix_cases = 0
    for n in list(LEAF_WIDTHS.values()) + MIX_RAGGED:
        for r, k in MIX_BLOCKS:
            w = torch.rand((r, k), generator=dgen, device=dev) + 0.1
            w = w / w.sum(dim=1, keepdim=True)
            buf = torch.randn(k * n + 1, generator=dgen, device=dev)
            views = [("offset", buf[1:].view(k, n))]
            if n in MIX_RAGGED:
                views.append(("aligned", buf[:-1].view(k, n)))
            for how, x in views:
                require(x.is_contiguous() and (how == "aligned")
                        == (x.data_ptr() % 16 == 0),
                        f"mix_rows_flat case setup: {how} view at N={n}")
                got = fedavg_ops.mix_rows_flat(w, x)
                want = fedavg_ref.mix_rows_flat_ref(w, x)
                mix_err = max(mix_err, float((got - want).abs().max()))
                require(torch.equal(got, want),
                        f"mix_rows_flat not bitwise equal to its plain "
                        f"version at N={n} ({how}) R={r} K={k}")
                mix_cases += 1
    w_full = torch.rand((N_CLIENTS, N_CLIENTS), generator=gen) + 0.1
    w_full = (w_full / w_full.sum(dim=1, keepdim=True)).to(dev)
    dense = per_round(lambda x: fedavg_ops.mix_rows_flat(w_full, x))
    report["mix_rows_flat"] = dict(
        max_abs_err=mix_err,
        ms=kernel_ms(torch, dense), call_ms=time_ms(torch, dense),
        plain_ms=kernel_ms(torch, per_round(
            lambda x: fedavg_ref.mix_rows_flat_ref(w_full, x))),
        # one PyTorch call, same function
        library_ms=kernel_ms(torch, per_round(lambda x: torch.mm(w_full, x))),
        # each leaf read once and written once, W read once per call
        bound_ms=1e3 * max((8 * elems + 4 * len(LEAF_WIDTHS) * N_CLIENTS ** 2)
                           / PEAK_BYTES_S,
                           2 * N_CLIENTS * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")
    print(f"phase 1 ok: pow_race bitwise on {len(cases) * len(offsets)} "
          f"budgets; largest deviation fedavg_flat {fed_err:.3g} "
          f"(rtol {FLOAT_RTOL}, atol {FLOAT_ATOL}), digest_div_flat "
          f"{dig_err:.3g} (leaf sum {LEAF_SUM_REL} of sum|x|, residuals "
          f"rtol {FLOAT_RTOL}; {DIGEST_CALLS} calls bitwise equal) at the "
          f"leaves and {digest_cases} more cases (offset views, C in "
          f"{DIGEST_CLIENTS} x N in {DIGEST_WIDTHS}, (C, N) in "
          f"{DIGEST_HUGE_C}), mix_rows_flat "
          f"{mix_err:.3g} at (R, K) in "
          f"{MIX_BLOCKS} (rtol {FLOAT_RTOL}, atol {FLOAT_ATOL}, and "
          f"bitwise), and bitwise at {mix_cases} ragged-width and "
          f"misaligned cases (N in {MIX_RAGGED} and the leaves); times "
          + json.dumps({n: {key: report[n][key] for key in
                            ("ms", "plain_ms", "library_ms", "bound_ms")}
                        for n in ("fedavg_flat", "digest_div_flat",
                                  "mix_rows_flat")})
          + "; digest_div_flat per leaf: "
          + json.dumps(report["digest_div_flat"]["per_leaf_ms"])
          + "; pow_race C = 1: " + json.dumps(report["pow_race"]["c1"]),
          flush=True)
    return report


def drive_path(torch, dev, flags, want, what, falling=True):
    """Run ``launch.train`` with ``flags`` on the card, the launch counts
    set to 0 just before and read just after; check them against ``want``,
    the ledger, finite metrics and (``falling``) a falling global loss.
    Returns (args, result, state, history, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}
    kernels.reset_launch_counts()
    result, state, hist = train.train_mlp(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(launches == want,
            f"launch counts {launches} on the {what}, expected {want}")
    require(result["chain_valid"] and result["blocks"] == args.k,
            f"ledger not valid on the {what}: {result}")
    for h in hist:
        require(all(math.isfinite(h[k]) for k in
                    ("local_loss_mean", "global_loss", "divergence")),
                f"non-finite metrics on the {what}: {h}")
    require(not falling or hist[-1]["global_loss"] < hist[0]["global_loss"],
            f"global loss did not fall on the {what}: "
            f"{[h['global_loss'] for h in hist]}")
    require(all(math.isfinite(v.float().abs().sum().item())
                for v in state.params.values()),
            f"non-finite params on the {what}")
    return args, result, state, hist, launches


def phase_main_path(torch, dev, flags, want, what, label):
    """Phases 2 and 2b: a full-width path on the card, through its
    kernels, with no host sync inside its rounds."""
    args, result, state, hist, launches = drive_path(torch, dev, flags, want,
                                                     what)
    require(result["tau"] == 10, f"tau {result['tau']} != 10")
    syncs = round_host_syncs(torch, args)
    require(not syncs, f"{len(syncs)} host syncs inside the rounds of the "
                       f"{what}: {syncs[:3]}")
    print(f"phase {label} ok: " + json.dumps(
        {"path": what, "launches": launches, "dispatch": result["dispatch"],
         "global_loss": [h["global_loss"] for h in hist],
         "final_eval_acc": result["final_eval_acc"],
         "ergodic_gap": result["ergodic_gap"],
         "host_syncs_in_rounds": len(syncs),
         "wall_s_first_run": result["wall_s"]}), flush=True)
    return args, result, state, hist, launches


def phase_adversarial(torch, dev):
    """Phase 2c: the adversarial paths at K = 2, on the card. An attack may
    keep the loss from falling, so only the ledger, the launch counts and
    finite metrics are required."""
    base = MAIN_ARGS + ["--k", str(K_ADV)]   # the last --k wins
    for extra in ADVERSARIAL_ARGS:
        fused = "--fused-mix" in extra
        want = {"pow_race": K_ADV, "fedavg_flat": 0,
                "mix_rows_flat": 4 * K_ADV if fused else 0,
                "digest_div_flat": 4 * K_ADV}
        what = "path " + " ".join(extra)
        _, result, _, hist, launches = drive_path(torch, dev, base + extra,
                                                  want, what, falling=False)
        print("phase 2c ok: " + json.dumps(
            {"path": what, "launches": launches,
             "dispatch": result["dispatch"],
             "global_loss": [h["global_loss"] for h in hist]}), flush=True)


def host_syncs(torch, fn):
    """Run ``fn()`` with CUDA's sync debug mode on and return the warnings
    of the host syncs it makes."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def round_host_syncs(torch, args):
    """The host syncs of the K rounds of the path ``args`` selects (no
    end-of-run transfer). The design makes none: the carry, the metrics,
    the mixing matrices (uploaded before the loop) and every input of the
    race stay on the device."""
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    table = rounds.mix_matrices(spec, blade.K, blade.seed + 2, dev)
    state = rounds.init_state({k: v.to(dev) for k, v in params.items()},
                              spec.n_clients,
                              torch.Generator().manual_seed(blade.seed + 2))
    round_fn = rounds.make_integrated_round(mlp_client_losses, spec,
                                            n_rounds=blade.K, device=dev)
    batch = src.static_batch()

    def run(state=state):
        for k in range(blade.K):
            matrix = None if table is None else table[k % len(table)]
            state, _ = round_fn(state, batch, matrix)

    return host_syncs(torch, run)


def round_ms(torch, args, profile_dir, tag):
    """ms per round of a warm run of a path: the trainer's host-clock
    ``wall_s`` (K rounds ending in the one host transfer, the ledger and
    the final eval) over K. With ``profile_dir``, also profile the K-round
    loop alone into ``profile_rounds_<tag>.txt`` and report the device's
    busy share of it."""
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
        path = os.path.join(profile_dir, f"profile_rounds_{tag}.txt")
        with open(path, "w") as f:
            for key in ("cuda_time_total", "cpu_time_total"):
                f.write(p.key_averages().table(sort_by=key, row_limit=40))
                f.write("\n")
        print(f"profile {tag}: K = {blade.K} rounds in {wall_ms:.3f} ms (host "
              f"clock, under the profiler); device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f} %); tables in "
              f"{path}", flush=True)
    return 1e3 * result["wall_s"] / K


def phase_card_vs_cpu(torch, args, result, state, hist, label,
                      consensus):
    """Phases 3, 3b and 3c: the same run on the CPU (plain versions, the
    same draws of the lazy noise and of W) against the card's: every
    per-round metric, the aggregate model the trainer evaluates and its
    eval loss within rtol CARD_CPU_RTOL / atol CARD_CPU_ATOL; every
    client's final params within that tolerance on a ``consensus`` path,
    else within CLIENT_SPREAD_LIMIT times it.

    Without consensus (phases 3b and 3c) every client keeps its own
    trajectory and the last-bit differences of the local-training GEMMs
    (cuBLAS against the CPU's) grow along it, while the metrics, the
    aggregate and the eval loss stay inside the tolerance.
    ``mix_rows_flat`` is held bitwise to its plain version in phase 1, so
    the kernel adds nothing to that spread. The wider limit still sees a
    fault in one client's row: the phase checks that the CPU's params with
    a planted PLANTED_LEAK of client 1's model in client 0 break it."""
    from repro_torch.core import aggregation
    from repro_torch.launch import train

    cpu_args = argparse.Namespace(**{**vars(args), "device": "cpu"})
    cpu_result, cpu_state, cpu_hist = train.train_mlp(cpu_args)

    def ratio(a, b):   # |a - b| over the tolerance at b; <= 1 passes
        a = torch.as_tensor(a, dtype=torch.float64).cpu()
        b = torch.as_tensor(b, dtype=torch.float64)
        return float(((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                       * b.abs())).max())

    gated = {key: max(ratio(a[key], b[key]) for a, b in zip(hist, cpu_hist))
             for key in ("local_loss_mean", "global_loss", "divergence")}
    gated["final_eval_loss"] = ratio(result["final_eval_loss"],
                                     cpu_result["final_eval_loss"])
    agg = aggregation.aggregate_once(state.params)
    cpu_agg = aggregation.aggregate_once(cpu_state.params)
    for name, v in agg.items():
        gated[f"aggregate {name}"] = ratio(v, cpu_agg[name])
    limit = 1.0 if consensus else CLIENT_SPREAD_LIMIT
    clients = {f"client {name}": ratio(v, cpu_state.params[name])
               for name, v in state.params.items()}
    # on a consensus path every client holds the same model, so a leak
    # between two of them changes nothing: the control is for the others
    planted = {}
    for name, v in cpu_state.params.items():
        faulty = v.clone()
        faulty[0] = (1 - PLANTED_LEAK) * v[0] + PLANTED_LEAK * v[1]
        planted[f"client {name}"] = 0.0 if consensus else ratio(faulty, v)
    print(f"phase {label}: card vs cpu, worst |diff| / (atol + rtol |cpu|): "
          f"{json.dumps(gated)}; per-client params (limit {limit}): "
          f"{json.dumps(clients)}; planted fault (limit {limit}): "
          f"{json.dumps(planted)}", flush=True)
    bad = sorted(k for k, r in gated.items() if not r <= 1)
    bad += sorted(k for k, r in clients.items() if not r <= limit)
    require(not bad, f"{bad} differ between card and cpu beyond rtol "
                     f"{CARD_CPU_RTOL} atol {CARD_CPU_ATOL} (per-client "
                     f"params: {limit} times that)")
    require(consensus or max(planted.values()) > limit,
            f"a planted {PLANTED_LEAK} leak between two clients stays "
            f"inside the per-client limit {limit}: {planted}")
    print(f"phase {label} ok: card vs cpu over {args.k} rounds within rtol "
          f"{CARD_CPU_RTOL} atol {CARD_CPU_ATOL}, worst |diff|/tol "
          f"{max(gated.values()):.3g}; per-client params worst "
          f"{max(clients.values()):.3g} (limit {limit})"
          + ("" if consensus else ", a planted fault "
             f"{max(planted.values()):.3g}"), flush=True)


def _flash_work(b, h, hkv, s, d, causal, window):
    """(bytes, flops, exps) the attention function needs: q, k, v read
    once and o written once; 4 D flops (QK^T and PV) and one exp per
    (row, key) pair the masks keep."""
    pairs = 0
    for row in range(s):
        lo = max(0, row - window + 1) if window > 0 else 0
        hi = row + 1 if causal else s
        pairs += hi - lo
    pairs *= b * h
    return (4 * (2 * b * s * h * d + 2 * b * s * hkv * d), 4 * d * pairs,
            pairs)


def _ssm_work(b, t, d_in, ds):
    """(bytes, flops, exps) of the scan: u and dt read, y written, B_t,
    C_t, a and d_skip read, h written once; per (b, t, channel, state) one
    exp and 5 flops (dt * a, the state's mul-add, the output's mul-add),
    per (b, t, channel) 3 more (dt * u, u * d_skip, the add)."""
    n = b * t * d_in
    return (4 * (3 * n + 2 * b * t * ds + d_in * ds + d_in + b * d_in * ds),
            5 * n * ds + 3 * n, n * ds)


def _bound(bytes_, flops, exps, tf32_passes=0):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the operations over their peak: fp32 flops outside the tensor
    cores, or, with ``tf32_passes``, that many TF32 passes of each flop on
    the tensor cores; exponentials on the SFU."""
    flop_s = (tf32_passes * flops / PEAK_TF32_S if tf32_passes
              else flops / PEAK_ALU_OPS_S)
    times = {"bytes": bytes_ / PEAK_BYTES_S,
             "operations": max(flop_s, exps / PEAK_EXP_S)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def phase_lm_kernels(torch, dev):
    """Phase 1b: the serve path's two kernels against their plain versions
    on the card, at the path's shapes and the listed cases, and their
    times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    gen = torch.Generator(device=dev).manual_seed(4321)
    report = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    flash_err = flash_bf16_err = 0.0
    for b, h, hkv, s, d, causal, window, bf16 in FLASH_CASES:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        if bf16:
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        if h == hkv:   # the TPU kernel's [B, H, S, D] layout
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            got = flash_ops.flash_attention(qt, kt, vt, causal=causal,
                                            window=window)
            want = flash_ref.attention_ref(qt.float(), kt.float(),
                                           vt.float(), causal=causal,
                                           window=window)
        else:
            got = flash_ops.mha(q, k, v, causal=causal, window=window)
            want = flash_ref.mha_ref(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
        err = (got.float() - want).abs()
        case = (b, h, hkv, s, d, causal, window, "bf16" if bf16 else "fp32")
        if bf16:
            flash_bf16_err = max(flash_bf16_err, float(err.max()))
            ok = bool((err <= FLASH_BF16_ATOL
                       + FLASH_BF16_RTOL * want.abs()).all())
        else:
            flash_err = max(flash_err, float(err.max()))
            ok = bool((err <= FLASH_ATOL
                       + FLASH_RTOL * want.abs()).all())
        require(ok, f"flash_attention off tolerance at {case}: max |diff| "
                    f"{float(err.max()):.3g}")
        del q, k, v, got, want, err
    for b, h, hkv, s, d, causal, window, how in FLASH_MISALIGNED:
        def view(heads):
            if how == "offset":
                return randn(b * s * heads * d + 1)[1:].view(b, s, heads, d)
            return randn(b, s, heads, d + 1)[..., :d]
        q, k, v = view(h), view(hkv), view(hkv)
        require(all((x.data_ptr() % 16 != 0) if how == "offset"
                    else any(st % 4 for st in x.stride()[:3])
                    for x in (q, k, v)),
                f"flash_attention case setup: {how} view at D={d}")
        got = flash_ops.mha(q, k, v, causal=causal, window=window)
        want = flash_ref.mha_ref(q, k, v, causal=causal, window=window)
        err = (got - want).abs()
        flash_err = max(flash_err, float(err.max()))
        require(bool((err <= FLASH_ATOL + FLASH_RTOL * want.abs()).all()),
                f"flash_attention off tolerance at {(b, h, hkv, s, d)} "
                f"({how} view): max |diff| {float(err.max()):.3g}")
        del q, k, v, got, want, err

    b, h, hkv, s, d = FLASH_PATH
    q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)

    def flash():
        return flash_ops.mha(q, k, v, causal=True)

    def sdpa():   # timed only: the port never calls it
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    require(float((sdpa().transpose(1, 2) - flash()).abs().max()) < 1e-4,
            "SDPA and the flash kernel disagree at the path shape")
    work = _flash_work(b, h, hkv, s, d, True, 0)
    bound, by = _bound(*work, tf32_passes=FLASH_TF32_PASSES)
    # the same work as one fp32 pass outside the tensor cores, printed on
    # this phase's line only: the kernel's bound is the 3xTF32 one
    bound_simt = _bound(*work)[0]
    report["flash_attention"] = dict(
        max_abs_err=flash_err, max_abs_err_bf16=flash_bf16_err,
        ms=kernel_ms(torch, flash, reps=10),
        call_ms=time_ms(torch, flash, reps=10, warmup=2),
        plain_ms=kernel_ms(torch, lambda: flash_ref.mha_ref(
            q, k, v, causal=True), reps=3),
        library_ms=kernel_ms(torch, sdpa, reps=10),
        bound_ms=bound, bound_by=by)
    del q, k, v

    ssm_err, ssm_ratio = 0.0, 0.0
    ssm_cases = ([(case, False) for case in SSM_CASES
                  + ssm_edge_cases(ssm_ref.CHUNK)]
                 + [(case, True) for case in SSM_MISALIGNED])
    for (bsz, t, d_in, ds), offset in ssm_cases:
        def place(x):   # the same values in a view one float past aligned
            if not offset:
                return x
            view = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
            return view.copy_(x)

        u, bm, cm = randn(bsz, t, d_in), randn(bsz, t, ds), randn(bsz, t, ds)
        dt = F.softplus(randn(bsz, t, d_in) - 2)
        a = -torch.exp(0.3 * randn(d_in, ds))
        dsk = 0.5 + torch.rand(d_in, generator=gen, device=dev)
        u, dt, bm, cm = (place(x) for x in (u, dt, bm, cm))
        require(not offset or all(x.data_ptr() % 16 for x in (u, dt, bm, cm)),
                f"ssm_scan case setup: offset views at {(bsz, t, d_in, ds)}")
        y, hf = ssm_ops.ssm_scan(u, dt, bm, cm, a, dsk)
        ry, rh = ssm_ref.ssm_scan_ref(u, dt, bm, cm, a, dsk)
        for got, want in ((y, ry), (hf, rh)):
            err = (got - want).abs()
            ssm_err = max(ssm_err, float(err.max()))
            ratio = float((err / (SSM_ATOL + SSM_RTOL * want.abs())).max())
            ssm_ratio = max(ssm_ratio, ratio)
            require(ratio <= 1, f"ssm_scan off tolerance at B={bsz} T={t} "
                                f"d_in={d_in} ds={ds}: max |diff| "
                                f"{float(err.max()):.3g}, {ratio:.3g} of "
                                f"atol {SSM_ATOL} + rtol {SSM_RTOL} |want|")
    bsz, t, d_in, ds = SSM_PATH
    u, bm, cm = randn(bsz, t, d_in), randn(bsz, t, ds), randn(bsz, t, ds)
    dt = F.softplus(randn(bsz, t, d_in) - 2)
    a = -torch.exp(0.3 * randn(d_in, ds))
    dsk = torch.ones(d_in, device=dev)

    def scan():
        return ssm_ops.ssm_scan(u, dt, bm, cm, a, dsk)

    bound, by = _bound(*_ssm_work(bsz, t, d_in, ds))
    report["ssm_scan"] = dict(
        max_abs_err=ssm_err, worst_of_tolerance=ssm_ratio,
        ms=kernel_ms(torch, scan, reps=10),
        call_ms=time_ms(torch, scan, reps=10, warmup=2),
        plain_ms=kernel_ms(torch, lambda: ssm_ref.ssm_scan_ref(
            u, dt, bm, cm, a, dsk), reps=2),
        library_ms=None, bound_ms=bound, bound_by=by)
    print(f"phase 1b ok: flash_attention at {len(FLASH_CASES)} cases and "
          f"{len(FLASH_MISALIGNED)} misaligned fp32 views, largest "
          f"deviation {flash_err:.3g} in fp32 (rtol {FLASH_RTOL}, "
          f"atol {FLASH_ATOL}) and {flash_bf16_err:.3g} in bf16 (rtol "
          f"{FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}); its bound "
          f"{bound_simt:.4g} ms as one fp32 pass outside the tensor cores, "
          f"{report['flash_attention']['bound_ms']:.4g} ms as "
          f"{FLASH_TF32_PASSES} TF32 passes (the kernel's); ssm_scan at "
          f"{len(ssm_cases)} cases ({len(SSM_MISALIGNED)} of offset "
          f"views), largest deviation {ssm_err:.3g}, "
          f"{ssm_ratio:.3g} of atol {SSM_ATOL} + "
          f"rtol {SSM_RTOL} |want|; times " + json.dumps(
              {n: {key: report[n][key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
               for n in ("flash_attention", "ssm_scan")}), flush=True)
    return report


def phase_serve(torch, dev, flags, want_lm, label):
    """Phase 4: ``launch.serve`` on the card, the launch counts set to 0
    just before and read just after: the prefill's kernels exactly as
    ``want_lm`` says, every FL kernel 0 (decode runs no kernel), finite
    logits. Returns (result, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(flags + ["--device", str(dev)])
    kernels.reset_launch_counts()
    result = serve.serve(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want_lm}
    require(launches == want, f"launch counts {launches} on the serve path "
                              f"{' '.join(flags)}, expected {want}")
    require(result["finite"], f"non-finite logits on the serve path: {result}")
    print(f"phase {label} ok: " + json.dumps(
        {key: result[key] for key in
         ("arch", "batch", "prompt_len", "generated_tokens", "prefill_s",
          "decode_s", "tokens_per_s", "peak_mem_gb", "launches")}),
        flush=True)
    return result, launches


def phase_serve_agreement(torch, dev, profile_dir):
    """Phase 4b: on the serve path's full-width params (the same seed),
    (i) prefill of AGREE_PREFILL tokens and AGREE_STEPS teacher-forced
    decode steps against one forward over all of them (logits at the
    prefill's last and each decode position; the forward runs the flash
    kernel at the ragged S = AGREE_PREFILL + AGREE_STEPS), then the decode
    loop's host syncs; (ii) AGREE_DECODE_LEN tokens decoded one by one from
    an empty state (plain torch, no kernel) against the forward's logits at
    every position. With ``profile_dir``, profile one prefill and report
    where its device time goes."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer

    args = serve.build_parser().parse_args(SERVE_ARGS + ["--device", str(dev)])
    cfg = serve.config_of(args)
    params = registry.init_model(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    n = AGREE_PREFILL + AGREE_STEPS
    tokens = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
        ShapeConfig("agree", n, args.batch, "prefill"))["tokens"]

    def full_logits(toks, positions):
        h, _ = transformer.forward(
            params, cfg, transformer._embed_inputs(params, cfg,
                                                   {"tokens": toks}))
        return transformer._lm_head(params, cfg, h[:, positions])

    want = full_logits(tokens, slice(AGREE_PREFILL - 1, n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = transformer.prefill(
        params, cfg, {"tokens": tokens[:, :AGREE_PREFILL]},
        max_len=n + SYNC_CHECK_STEPS)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = [logits]
    for t in range(AGREE_PREFILL, n):
        logits, state = transformer.decode_step(params, cfg, state,
                                                tokens[:, t], t)
        got.append(logits)
    err_i = float((torch.stack(got, 1) - want).abs().max())
    # greedy steps of serve's decode loop, in CUDA's sync debug mode
    syncs = host_syncs(torch, lambda: serve.decode_loop(
        params, cfg, state, torch.argmax(logits, -1), n, SYNC_CHECK_STEPS))
    del state, got, want

    m = AGREE_DECODE_LEN
    want = full_logits(tokens[:, :m], slice(0, m))
    state = transformer.init_decode_state(cfg, args.batch, m,
                                          device=dev)
    err_ii = 0.0
    for t in range(m):
        logits, state = transformer.decode_step(params, cfg, state,
                                                tokens[:, t], t)
        err_ii = max(err_ii, float((logits - want[:, t]).abs().max()))
    scale = float(want.abs().max())
    del state, want
    print(f"phase 4b: max |logit diff| (i) prefill + {AGREE_STEPS} decode "
          f"steps vs forward over {n} tokens: {err_i:.3g}; (ii) {m} decode "
          f"steps from an empty state vs forward: {err_ii:.3g}; max |logit| "
          f"{scale:.3g}; limit {AGREE_LIMIT}; host syncs in "
          f"{SYNC_CHECK_STEPS} decode steps: {len(syncs)}; a second "
          f"prefill of {AGREE_PREFILL} tokens took {prefill_s:.3f} s",
          flush=True)
    require(err_i <= AGREE_LIMIT and err_ii <= AGREE_LIMIT,
            f"serve path disagrees with the forward: {err_i:.3g}, "
            f"{err_ii:.3g} > {AGREE_LIMIT}")
    require(not syncs, f"{len(syncs)} host syncs in the decode loop: "
                       f"{syncs[:3]}")
    if profile_dir:
        prefill_breakdown(torch, params, cfg, tokens[:, :AGREE_PREFILL],
                          profile_dir)
    print("phase 4b ok", flush=True)


def prefill_breakdown(torch, params, cfg, tokens, profile_dir):
    """Profile one prefill; print its device time by class of kernel
    (GEMMs, the flash kernel, the scan kernel, everything else) and write
    the full table into ``profile_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch.models import transformer

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        transformer.prefill(params, cfg, {"tokens": tokens},
                            max_len=tokens.shape[1])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    classes = {"gemm": 0.0, "flash_attention": 0.0, "ssm_scan": 0.0,
               "other": 0.0}
    for e in p.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        if "flash_fwd" in name:
            key = "flash_attention"
        elif "ssm_scan_kernel" in name:
            key = "ssm_scan"
        elif "gemm" in name or "cutlass" in name or "matmul" in name:
            key = "gemm"
        else:
            key = "other"
        classes[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(classes.values())
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "profile_prefill.txt")
    with open(path, "w") as f:
        f.write(p.key_averages().table(sort_by="cuda_time_total",
                                       row_limit=40))
    print("prefill profile: " + json.dumps(
        {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
         "device_ms_by_class": classes}) + f"; table in {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one warm run of the rounds of the "
                         "paper's and the topology path and one prefill of "
                         "the serve path, and write the tables into DIR")
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
            if any(key in line for key in ("Compiling entry function",
                                           "registers", "spill")):
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    clock = [time.perf_counter()]

    def lap(label):   # each phase's seconds
        now = time.perf_counter()
        print(f"[{label}: {now - clock[0]:.1f} s]", flush=True)
        clock[0] = now

    report = phase_kernels(torch, dev)
    lap("phase 1")
    report.update(phase_lm_kernels(torch, dev))
    torch.cuda.empty_cache()
    lap("phase 1b")
    paper = {"pow_race": K, "fedavg_flat": 4 * K, "mix_rows_flat": 0,
             "digest_div_flat": 4 * K}
    args, result, state, hist, launches = phase_main_path(
        torch, dev, MAIN_ARGS, paper, "paper's path", "2")
    topo = {"pow_race": K, "fedavg_flat": 0, "mix_rows_flat": 4 * K,
            "digest_div_flat": 4 * K}
    targs, tresult, tstate, thist, tlaunches = phase_main_path(
        torch, dev, TOPOLOGY_ARGS, topo, "topology path", "2b")
    require(tresult["dispatch"]["mix_mode"] == "exec_gather"
            and tresult["dispatch"]["pow"] == "kernel",
            f"topology path dispatch {tresult['dispatch']}")
    phase_adversarial(torch, dev)
    for tag, a in (("paper", args), ("topology", targs)):
        ms_round = round_ms(torch, a, opts.profile, tag)
        print(f"round time, {tag} path: {ms_round:.3f} ms per round (host "
              f"clock, warm run of K = {K} at C = {N_CLIENTS})", flush=True)
    phase_card_vs_cpu(torch, args, result, state, hist, "3", consensus=True)
    phase_card_vs_cpu(torch, targs, tresult, tstate, thist, "3b",
                      consensus=False)
    # the same comparison for a mix with no custom kernel (bitwise equal
    # rolls on both devices): its per-client spread is the GEMMs' alone
    rargs, rresult, rstate, rhist, _ = drive_path(
        torch, dev, RING_ARGS, {"pow_race": K, "fedavg_flat": 0,
                                "mix_rows_flat": 0, "digest_div_flat": 4 * K},
        "ring path")
    phase_card_vs_cpu(torch, rargs, rresult, rstate, rhist, "3c",
                      consensus=False)
    del state, tstate, rstate
    torch.cuda.empty_cache()
    lap("phases 2-3c")

    _, slaunches = phase_serve(torch, dev, SERVE_ARGS, SERVE_LAUNCHES, "4")
    lap("phase 4")
    phase_serve(torch, dev, SERVE_SMOKE_ARGS, SERVE_SMOKE_LAUNCHES,
                "4 (smoke)")
    phase_serve_agreement(torch, dev, opts.profile)
    lap("phase 4b")

    by_path = {"paper": launches, "topology": tlaunches, "serve": slaunches}
    table = [{"name": name, "route": "cuda",
              "source": os.path.relpath(_build.SOURCES[LIBRARY[name]], ROOT),
              "replaces": REPLACES[name],
              "launches": by_path[MAIN_PATH_OF[name]][name],
              "launches_by_path": {p: c[name] for p, c in by_path.items()},
              **report[name]} for name in REPLACES]
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
