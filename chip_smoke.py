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
   shapes of the main paths (the float kernels to a stated tolerance;
   ``mix_rows_flat`` bitwise, also at ragged widths and on misaligned
   views, where its float4 path cannot run; ``digest_div_flat`` three
   calls bitwise equal at every leaf, every leaf as an offset view, and C
   in DIGEST_CLIENTS x N in DIGEST_WIDTHS), with its time, the plain
   version's time, the time of one PyTorch call computing the same
   function where there is one, and its bound on an H100. The mine kernel
   is held bitwise in both modes, the race (``ops.pow_race_flat``) on
   RACE_CASES and the whole seal (``ops.mine_seal``) on SEAL_CASES
   (planted ties, all-max payloads, C = 1, budgets of several blocks a
   client), and timed at C = 20 and C = 1 (flat) and C = 20 (seal) beside
   the empty-launch floor, with its device operations a call, as is one
   call of the mine stage ``rounds.make_mine`` (2: the nonce offset's fill
   and the launch). Every timed function is read by the profiler and by
   CUDA events (``kernel_ms``); readings more than READING_SPREAD apart
   are noted before the kernel table;
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
   difficulty 4), run by the graph driver (the trainer's default for its
   static batch: a warm round, then CUDA-graph replays) and by the loop
   driver (``jit=False``): the two bitwise equal (params, every per-round
   metric, the ledger), every kernel's launch count read around each run,
   no host sync in the loop's rounds nor in the replays (the graph
   driver's set-up syncs printed, not gated), and a profile of the
   replays that counts each FL kernel's launches by name as the launch
   counts do; then a ``[K, C, ...]`` stacked batch through
   ``rounds.run_blade_fl`` by the graph driver, the loop driver and as a
   per-round callable, the three bitwise equal; ``round_ms`` prints both
   drivers' round times, the graph runs' growth of reserved device memory
   and, under ``--profile``, their device busy share and device
   operations a round (the replays alone as well);
2b. the topology path: the same configuration with ``--topology
   random:0.5 --fused-mix`` (per-round link dropout, the dense mix on the
   ``mix_rows_flat`` kernel), checked the same way;
2c. the adversarial paths at K = 2: ``--attack alie --attackers 2
   --robust median`` and ``--topology snr --fused-mix --attack signflip``,
   each by both drivers, bitwise equal, with exact launch counts and no
   host sync in the loop's rounds nor in the replays (as every path run by
   both drivers, 3c's ring too);
2d. graph variants: ``--topology rotate --eval-every 2`` at K = 21 (a
   shift-schedule phase and the eval stride pick the graph: 19 graphs of
   one pool for 20 replays, the last replayed out of capture order) by
   both drivers, bitwise equal, with exact launch counts and no host sync
   in the loop's rounds nor in the replays;
3. and 3b. the runs of phases 2 and 2b on the CPU (plain versions), held
   against the card's; 3c. the same for ``--topology ring`` (also run by
   both drivers), a non-consensus mix that runs no custom kernel.
   Per-client params of the non-consensus paths are held to
   ``CLIENT_SPREAD_LIMIT`` times the tolerance, a limit a planted one-row
   fault is shown to break;
4. the serve path, ``repro_torch.launch.serve --arch jamba-1.5-large-398b
   --size one-h100 --batch 4 --prompt-len 2048 --gen 32`` (Jamba at its
   published widths, 8 layers, dense MLPs: 9.0 G parameters): one prefill
   launches ``flash_attention`` once and ``ssm_scan`` 7 times, decode no
   kernel; then the phi4-mini smoke config (2 flash launches);
4b. on the same full-width params, prefill + 8 decode steps against one
   forward over 2056 tokens, and 256 decode steps from an empty state
   against the forward, in max |logit diff| <= ``AGREE_LIMIT``, and no
   host sync in the decode loop;
5. the paper's K sweep (``repro_torch.benchmarks.paper_tables
   .fig3_bound_gap``: C = 20, 256 samples a client, Dir(0.2), t_sum 100,
   alpha 1, beta 6, eta 0.005, K in 1-6, 8, 14) by each driver: its rows
   (K, empirical loss, bound), ``bound_above`` (required), ``k_emp``,
   ``k_bound`` and the gap at the optimum (printed), and the sweep's wall
   time by each driver; then the sweep at K in SWEEP_CARD_CPU_KS on the
   card against the CPU within rtol 1e-4 / atol 1e-5;
6. the cohort path (``launch.train --enrolled``): 6a ``fedavg_flat``,
   ``digest_div_flat`` and the seal at every cohort size the phase runs
   (COHORT_SIZES) on every leaf, ``mix_rows_flat`` bitwise at
   MIX_COHORT_BLOCKS (R = K = 16 and 128 as the dense paths run it, and K
   past one 64-k stage of w_rows), and their times at the cohort sizes;
   6b the paper's configuration on a cohort of 64 of 10 000 enrolled
   clients, then of 128 under ``--topology random:0.5 --fused-mix``:
   launch counts, the ledger, memberships replayed from the seed,
   ``touched``, at most one host sync a round, peak device memory under
   COHORT_PEAK_GB, each round's host-clock split and a profiled busy
   share; 6c the degenerate cohort (20 of 20, ``prefix``) bitwise equal
   to the loop driver; 6d 1 000 enrolled, cohort 16, card against CPU.

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
# the two device-time readings of a function (profiler, CUDA events) are
# flagged, as a note, when they differ by more than this share
READING_SPREAD = 0.10
# when none of them does, the operations-a-call gates take the largest
# count seen, which may lie this many activities below the count wanted
# (the profiler drops activities now and then and never adds one; on an
# H100, one or two from a profile of 50 calls, and in one profile of the
# many taken, 61 of 100, which the next profile did not repeat)
PROFILE_DROP_LIMIT = 3
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
# phase 2d: a periodic shift schedule with an eval stride, so that the
# graph driver captures one graph a (phase, evaluates) variant. At C = 20
# the rotation's period is 19: K = 21 takes 19 graphs for its 20 replays,
# and the last round replays the graph first captured for round 1
K_VARIANTS = 21
# (t_sum 420 keeps tau at the paper path's 10 at this K)
VARIANT_ARGS = MAIN_ARGS + ["--k", str(K_VARIANTS), "--t-sum", "420",
                            "--topology", "rotate", "--eval-every", "2"]
# FL kernel wrapper -> a part of its kernel's name in a profile
KERNEL_SYMBOL = {"pow_race": "mine_kernel", "fedavg_flat": "fedavg_kernel",
                 "digest_div_flat": "digest_div_",
                 "mix_rows_flat": "mix_rows_kernel"}
N_CLIENTS = 20
LEAF_WIDTHS = {"b1": 256, "b2": 10, "w1": 784 * 256, "w2": 256 * 10}
MINE_ATTEMPTS = 10240
# (C, n_attempts, chunk) the race is held to its plain version at: chunk
# None lets the wrapper pick the tile (ops.race_tile: one block a client
# up to 16 384 attempts, else several and the ticket), a number forces
# that tile (several blocks a client); the main path's budget both ways,
# tails, C = 1, several blocks a client, one attempt
RACE_CASES = [(N_CLIENTS, MINE_ATTEMPTS, None), (N_CLIENTS, MINE_ATTEMPTS, 1024),
              (N_CLIENTS, 3000, 1024), (N_CLIENTS, 1000, 384),
              (1, MINE_ATTEMPTS, None), (1, MINE_ATTEMPTS, 1024), (7, 4097, 256),
              (7, 40000, None), (N_CLIENTS, 1 << 20, None), (1, 1 << 24, None),
              (3, 1, None), (100, 20000, None)]
# (C, n_attempts, chunk, payloads, difficulty bits) for the seal mode:
# "salt" salts the digest in the kernel, "ties" plants the best payload at
# TIE_CLIENTS, "max" gives every client one hash of 0xFFFFFFFF
SEAL_CASES = [(N_CLIENTS, MINE_ATTEMPTS, None, "salt", 4),
              (N_CLIENTS, MINE_ATTEMPTS, 1024, "salt", 4),
              (1, MINE_ATTEMPTS, None, "salt", 4), (1, MINE_ATTEMPTS, 1024, "salt", 0),
              (7, 4097, 256, "salt", 32), (N_CLIENTS, 1 << 20, None, "salt", 8),
              (1, 1 << 24, None, "salt", 4), (100, 20000, None, "salt", 4),
              (7, 40000, None, "salt", 4),
              (N_CLIENTS, MINE_ATTEMPTS, None, "ties", 4),
              (N_CLIENTS, MINE_ATTEMPTS, 1024, "ties", 4),
              (N_CLIENTS, 1 << 20, None, "ties", 4),
              (5, 1, None, "max", 4), (5, 1, None, "max", 0),
              (1, 1, None, "max", 0)]
TIE_CLIENTS = [3, 8, 19]
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
# path -> what launched its kernels in the counted run: the FL paths' static
# batch runs on the graph driver (a warm round and K - 1 replays, the
# replays' launches added by the driver); the serve path calls the wrappers
LAUNCHED_BY = {"paper": "graph driver", "topology": "graph driver",
               "serve": "eager calls"}
# phase 5: the paper's K sweep in Fig. 3's configuration
# (paper_tables.fig3_bound_gap), and the Ks held card against CPU: tau 10,
# 6 and 1, at most 60 local steps a run
FIG3_CONFIG = dict(eta=0.005, alpha=1.0, beta=6.0, t_sum=100.0)
SWEEP_CARD_CPU_KS = [6, 8, 14]
# the (R, K) blocks mix_rows_flat is held to its plain version at: the
# main path's full W, a row block, a column block, the largest it takes
MIX_BLOCKS = [(N_CLIENTS, N_CLIENTS), (5, N_CLIENTS), (N_CLIENTS, 5),
              (64, 64)]
# widths where the kernel's float4 path cannot run: N = 1, 2, 3 (mod 4), the
# first at the widest leaf's width; each is also held on a contiguous view
# whose storage starts one float past an aligned address, as is every leaf
MIX_RAGGED = [784 * 256 + 1, 2050, 7]
# phase 6: the cohort path (launch/train.py --enrolled): the paper's
# configuration on a cohort of 64 of 10 000 enrolled clients a round, then
# a cohort of 128 mixed densely by mix_rows_flat at R = K = 128
COHORT_ARGS = MAIN_ARGS + ["--enrolled", "10000", "--cohort", "64",
                           "--cohort-bias", "uniform"]
COHORT_DENSE_ARGS = MAIN_ARGS + ["--enrolled", "10000", "--cohort", "128",
                                 "--cohort-bias", "uniform", "--topology",
                                 "random:0.5", "--fused-mix"]
# a run's peak of allocated device memory: a [10 000, N] fp32 population
# alone would be 8.1 GB
COHORT_PEAK_GB = 3.0
COHORT_C = 64   # the FL kernels at the first run's cohort size
# 6c: the degenerate cohort, every client every round, against the loop
DEGENERATE_ARGS = MAIN_ARGS + ["--enrolled", "20", "--cohort", "20",
                               "--cohort-bias", "prefix"]
# 6d: card against CPU at a reduced size, a consensus and a dense mix
COHORT_CPU_ARGS = ["--arch", "mlp", "--k", "3", "--enrolled", "1000",
                   "--cohort", "16", "--lazy", "2", "--sigma2", "0.01",
                   "--seed", "0"]
COHORT_CPU_SAMPLES = 64   # a client (train.train_cohort's ``samples``)
COHORT_CPU_TOPOLOGIES = [("full", True), ("random:0.5", False)]
# the cohorts the phase-6 paths run: 6d's, then 6b's two (6c's 20 is the
# main path's C); each FL kernel of those paths is held at each of them
COHORT_SIZES = [16, 64, 128]
# mix_rows_flat, bitwise, at (R, K) x N: the dense paths' R = K = A, then
# blocks past one 64-k stage of w_rows, at every leaf width and at ragged
# ones
MIX_COHORT_BLOCKS = [(16, 16), (64, 64), (65, 65), (100, 100), (128, 128),
                     (20, 200), (200, 20), (256, 256)]
MIX_COHORT_WIDTHS = list(LEAF_WIDTHS.values()) + [784 * 256 + 1, 7]
MIX_TIMED = [(20, 20), (64, 64), (128, 128)]


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_ops(label, want):
    """The function timed as ``label`` launches ``want`` device operations
    a call: exactly, by a whole profile; with none, the largest count seen
    lies at most PROFILE_DROP_LIMIT activities below ``want`` a call."""
    from repro_torch.benchmarks import timing

    r = timing.READINGS[label]
    full = want * r["reps"]
    ok = r["ops"] == full if r["whole"] else \
        full - PROFILE_DROP_LIMIT <= r["ops"] < full
    require(ok, f"{label}: {r['ops']} device operations over {r['reps']} "
                f"calls{'' if r['whole'] else ' (no whole profile)'}, want "
                f"{want} a call")


def flag_readings():
    """Print, as a note, every function whose two device-time readings
    differ by more than READING_SPREAD of the events' reading."""
    from repro_torch.benchmarks import timing

    for label, r in timing.READINGS.items():
        p, e = r["profiler_ms"], r["events_ms"]
        if not r["whole"]:
            print(f"note: {label} has no whole profile ({r['ops']} device "
                  f"operations over {r['reps']} calls); its time is the "
                  "CUDA events'", flush=True)
        if abs(p - e) > READING_SPREAD * e:
            print(f"note: kernel_ms readings of {label} differ by "
                  f"{100 * (p - e) / e:+.1f} %: profiler {p:.6g} ms, CUDA "
                  f"events {e:.6g} ms, {r['ops_per_call']:g} device ops a "
                  "call", flush=True)


EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void repro_empty_kernel() {}
extern "C" int repro_empty_launch(int blocks, int threads, void* stream) {
  repro_empty_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_launch(torch, blocks=1, threads=32):
    """Build (with the port's nvcc flags) a kernel that does nothing and
    return a function that launches it once on the current stream with
    ``blocks`` x ``threads``: at one block of one warp, the floor under
    any single launch."""
    import ctypes

    from repro_torch.kernels import _build

    src = _build.BUILD_DIR / "empty_launch.cu"
    if not src.exists() or src.read_text() != EMPTY_KERNEL_CU:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(EMPTY_KERNEL_CU)
    lib = _build.load_file(src, "empty_launch")
    lib.repro_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.repro_empty_launch.restype = ctypes.c_int

    def launch():
        err = lib.repro_empty_launch(blocks, threads,
                                     torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"empty launch: CUDA error {err}")

    return launch


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


def same_seal(torch, got, want):
    """Two ``mine_seal`` results ``(metrics, new_hash)`` agree bitwise,
    dtypes included."""
    pairs = [(got[0][k], want[0][k]) for k in want[0]] + [(got[1], want[1])]
    return set(got[0]) == set(want[0]) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in pairs)


def phase_race(torch, dev):
    """Phase 1, the mine kernel: both modes against their plain versions,
    bitwise, on RACE_CASES and SEAL_CASES at two nonce offsets (the second
    wraps past 2**32), then their times beside the empty-launch floor, and
    the mine stage's device operations a call. Returns (the kernel table's
    row, a summary for phase 1's line)."""
    from repro_torch.benchmarks import timing
    from repro_torch.core import mining, rounds
    from repro_torch.kernels.pow_hash import ops as pow_ops
    from repro_torch.kernels.pow_hash import ref as pow_ref

    gen = torch.Generator().manual_seed(1357)

    def word(v):
        return torch.full((), int(v) & mining.MASK, dtype=torch.int64,
                          device=dev)

    def draw(c):
        return torch.randint(0, 2 ** 32, (c,), generator=gen,
                             dtype=torch.int64).to(dev)

    def draw_word():
        return word(torch.randint(0, 2 ** 32, (), generator=gen))

    offsets = [4 << 20, 0xFFFFFFFF - 500]
    checked = 0
    for c, n, chunk in RACE_CASES:
        for off in offsets:
            payloads, prev = draw(c), draw_word()
            h, nn = pow_ops.pow_race_flat(prev, payloads, word(off), n,
                                          chunk=chunk)
            rh, rn = pow_ref.pow_race_ref(prev, word(off), payloads, n)
            require(torch.equal(h, rh) and torch.equal(nn, rn),
                    f"pow_race differs from its plain version at C={c} "
                    f"n={n} chunk={chunk} off={off}")
            checked += 1
    # clients whose one hash is 0xFFFFFFFF keep nonce 0
    prev, off = 0x12345678, 0xFFFFFFF0
    max_payloads = torch.tensor(
        [pow_ref.payload_hashing_to(prev, off, mining.MASK)] * 5,
        dtype=torch.int64, device=dev)
    h, nn = pow_ops.pow_race_flat(word(prev), max_payloads, word(off), 1)
    require(h.tolist() == [mining.MASK] * 5 and nn.tolist() == [0] * 5,
            f"pow_race on all-max payloads: {h.tolist()}, {nn.tolist()}")
    # the salting wrapper at C = 1 is the single-client search
    h1, n1 = pow_ops.mine(word(7), word(0xCAFE), word(3), 2500,
                          nonce_offset=word(1 << 20))
    rh1, rn1 = mining.pow_search(7, 0xCAFE, 3, 2500, nonce_offset=1 << 20)
    require(int(h1) == int(rh1) and int(n1) == int(rn1),
            "single-client mine differs from mining.pow_search")

    seal_checked, ties = 0, 0
    for c, n, chunk, kind, bits in SEAL_CASES:
        for off in offsets:
            prev, digest = draw_word(), draw_word()
            payloads, want_winner = None, None
            if kind == "ties":
                # the best payload copied to clients TIE_CLIENTS, its own
                # slot given the worst one: the first of them must win
                payloads = draw(c)
                rh, _ = pow_ref.pow_race_ref(prev, word(off), payloads, n)
                best, worst = int(torch.argmin(rh)), int(torch.argmax(rh))
                best_payload = payloads[best].clone()
                payloads[best] = payloads[worst]
                payloads[TIE_CLIENTS] = best_payload
                want_winner = TIE_CLIENTS[0]
                ties += 1
            elif kind == "max":
                payloads = torch.tensor(
                    [pow_ref.payload_hashing_to(int(prev), off, mining.MASK)]
                    * c, dtype=torch.int64, device=dev)
                want_winner = 0
            args = (prev, digest, c, n)
            kw = dict(nonce_offset=word(off), difficulty_bits=bits,
                      payloads=payloads)
            got = pow_ops.mine_seal(*args, chunk=chunk, **kw)
            want = pow_ref.mine_seal_ref(prev, digest, word(off), c, n, bits,
                                         payloads)
            require(same_seal(torch, got, want),
                    f"mine_seal differs from its plain version at C={c} "
                    f"n={n} chunk={chunk} {kind} bits={bits} off={off}: "
                    f"{[int(v) for v in got[0].values()]} vs "
                    f"{[int(v) for v in want[0].values()]}")
            if want_winner is not None:
                require(int(want[0]["winner"]) == want_winner,
                        f"case setup: {kind} at C={c} won by "
                        f"{int(want[0]['winner'])}, not {want_winner}")
            if kind == "max":
                require(int(got[0]["nonce"]) == 0
                        and int(got[0]["pow_hash"]) == mining.MASK,
                        "mine_seal on all-max payloads keeps nonce 0")
            seal_checked += 1

    # times at the main path's shape: C = 20, MINE_ATTEMPTS, the tile the
    # wrapper picks (one block a client)
    payloads, prev, digest, off = draw(N_CLIENTS), word(99), word(0xCAFE), \
        word(4 << 20)
    salted = (digest ^ mining.client_salt(word(3))).reshape(1).contiguous()
    h1, n1 = pow_ops.mine(prev, digest, word(3), MINE_ATTEMPTS,
                          nonce_offset=off)
    rh1, rn1 = pow_ref.pow_race_ref(prev, off, salted, MINE_ATTEMPTS)
    require(int(h1) == int(rh1[0]) and int(n1) == int(rn1[0]),
            "mine at the main path's budget differs from its plain version")
    floor = empty_launch(torch)
    floor_ms = timing.kernel_ms(floor, "empty launch (the floor)", reps=50)
    floor_events_ms = timing.READINGS["empty launch (the floor)"]["events_ms"]

    def timed(label, fn, plain, c, bytes_):
        """``bytes_``: each input word read once and each output written
        once."""
        row = dict(ms=timing.kernel_ms(fn, label, reps=50))
        row.update(events_ms=timing.READINGS[label]["events_ms"],
                   device_ops=timing.READINGS[label]["ops_per_call"],
                   call_ms=timing.time_ms(fn),
                   plain_ms=timing.kernel_ms(plain, f"{label} plain"),
                   floor_ms=floor_ms, floor_events_ms=floor_events_ms,
                   bound_ms=1e3 * max(bytes_ / PEAK_BYTES_S,
                                      c * MINE_ATTEMPTS * OPS_PER_HASH
                                      / PEAK_ALU_OPS_S),
                   bound_by="operations")
        return row

    # the row's own numbers are the seal's at the main path's shape: every
    # launch the paths count is a seal; flat mode (the TPU kernel's
    # function) at C = 20 and C = 1 (its pow_search_kernel) are sub-rows
    bits = 4
    seal = "mine_seal (C = 20)"
    row = dict(max_abs_err=0, library_ms=None, **timed(
        seal,
        lambda: pow_ops.mine_seal(prev, digest, N_CLIENTS, MINE_ATTEMPTS,
                                  nonce_offset=off, difficulty_bits=bits),
        lambda: pow_ref.mine_seal_ref(prev, digest, off, N_CLIENTS,
                                      MINE_ATTEMPTS, bits), N_CLIENTS,
        8 * (3 + 4) + 1))
    row["flat"] = timed(
        "pow_race (flat, C = 20)",
        lambda: pow_ops.pow_race_flat(prev, payloads, off, MINE_ATTEMPTS),
        lambda: pow_ref.pow_race_ref(prev, off, payloads, MINE_ATTEMPTS),
        N_CLIENTS, 8 * (2 + 3 * N_CLIENTS))
    # the launch one ops.mine call of MINE_ATTEMPTS makes, on the payload
    # it salts
    row["c1"] = timed(
        "pow_race (flat, C = 1)",
        lambda: pow_ops.pow_race_flat(prev, salted, off, MINE_ATTEMPTS),
        lambda: pow_ref.pow_race_ref(prev, off, salted, MINE_ATTEMPTS), 1,
        8 * (2 + 3))
    spec = rounds.RoundSpec(n_clients=N_CLIENTS, tau=10, eta=0.05,
                            mine_attempts=MINE_ATTEMPTS, difficulty_bits=bits)
    mine = rounds.make_mine(spec)
    stage = "mine stage (rounds.make_mine, one call)"
    row["mine_stage"] = dict(ms=timing.kernel_ms(lambda: mine(prev, digest, 3),
                                          stage, reps=50),
                             events_ms=timing.READINGS[stage]["events_ms"],
                             device_ops=timing.READINGS[stage]["ops_per_call"])
    for label, want in ((seal, 1), ("pow_race (flat, C = 20)", 1),
                        ("pow_race (flat, C = 1)", 1), (stage, 2)):
        require_ops(label, want)
    summary = (f"pow_race bitwise at {checked} flat and {seal_checked} seal "
               f"cases ({ties} with planted ties, all-max payloads in both "
               f"modes); times " + json.dumps(
                   {k: row[k] for k in ("flat", "c1", "mine_stage")}))
    return row, summary


def phase_kernels(torch, dev):
    """Phase 1: each kernel against its plain version, and its times."""
    from repro_torch.benchmarks import timing
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

    report["pow_race"], race_summary = phase_race(torch, dev)

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
        ms=timing.kernel_ms(mix, "fedavg_flat"), call_ms=timing.time_ms(mix),
        plain_ms=timing.kernel_ms(per_round(
            lambda x: fedavg_ref.fedavg_flat_ref(x, uniform)),
            "fedavg_flat plain"),
        # one PyTorch call, same function: the mean-row matrix times x
        library_ms=timing.kernel_ms(per_round(lambda x: torch.mm(w_rows, x)),
                             "fedavg_flat library (torch.mm)"),
        bound_ms=1e3 * max((8 * elems + 16 * N_CLIENTS) / PEAK_BYTES_S,
                           2 * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")
    sweep = per_round(fedavg_ops.digest_div_flat)
    report["digest_div_flat"] = dict(
        max_abs_err=dig_err,
        ms=timing.kernel_ms(sweep, "digest_div_flat"), call_ms=timing.time_ms(sweep),
        plain_ms=timing.kernel_ms(per_round(fedavg_ref.digest_div_flat_ref),
                           "digest_div_flat plain"),
        library_ms=None,
        # each leaf's call alone: the narrow ones are one-block launches
        per_leaf_ms={name: timing.kernel_ms(lambda x=x:
                                     fedavg_ops.digest_div_flat(x),
                                     f"digest_div_flat leaf {name}")
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
        ms=timing.kernel_ms(dense, "mix_rows_flat"), call_ms=timing.time_ms(dense),
        plain_ms=timing.kernel_ms(per_round(
            lambda x: fedavg_ref.mix_rows_flat_ref(w_full, x)),
            "mix_rows_flat plain"),
        # one PyTorch call, same function
        library_ms=timing.kernel_ms(per_round(lambda x: torch.mm(w_full, x)),
                             "mix_rows_flat library (torch.mm)"),
        # each leaf read once and written once, W read once per call
        bound_ms=1e3 * max((8 * elems + 4 * len(LEAF_WIDTHS) * N_CLIENTS ** 2)
                           / PEAK_BYTES_S,
                           2 * N_CLIENTS * elems / PEAK_ALU_OPS_S),
        bound_by="bytes")
    print(f"phase 1 ok: largest deviation fedavg_flat {fed_err:.3g} "
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
          + "; " + race_summary, flush=True)
    return report


def counted_run(torch, args, jit):
    """``launch.train``'s run of ``args`` on the driver ``jit`` picks, the
    launch counts set to 0 just before and read just after. Returns
    (result, state, history, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import train

    kernels.reset_launch_counts()
    result, state, hist = train.train_mlp(args, jit=jit)
    torch.cuda.synchronize()
    return result, state, hist, kernels.launch_counts()


def drive_path(torch, dev, flags, want, what, falling=True):
    """Run ``launch.train`` with ``flags`` on the card, by the graph driver
    (the trainer's default for its static batch) and by the loop driver
    (``jit=False``); check both runs' launch counts against ``want``, that
    the two runs agree bitwise (params, every per-round metric, the ledger's
    fields and head), the ledger, finite metrics, (``falling``) a falling
    global loss, and that neither the loop's rounds nor the replays make a
    host sync (``round_host_syncs``, kept in ``result["host_syncs"]``).
    Returns (args, result, state, history, launches) of the graph driver's
    run."""
    from repro_torch import kernels
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}
    result, state, hist, launches = counted_run(torch, args, True)
    lresult, lstate, lhist, llaunches = counted_run(torch, args, False)
    for driver, res, counts in (("graph", result, launches),
                                ("loop", lresult, llaunches)):
        require(res["dispatch"]["driver"] == driver,
                f"the {what} ran on {res['dispatch']}, expected {driver}")
        require(counts == want, f"launch counts {counts} on the {what} "
                                f"({driver} driver), expected {want}")
    require(json.dumps(hist) == json.dumps(lhist)
            and torch.equal(state.prev_hash, lstate.prev_hash)
            and all(torch.equal(v, lstate.params[k])
                    for k, v in state.params.items()),
            f"graph and loop drivers differ on the {what}")
    require(result["chain_valid"] and result["blocks"] == args.k,
            f"ledger not valid on the {what}: {result}")
    # the rounds the eval stride evaluates: every eval_every-th and the last
    evals = [args.eval_every <= 1 or (k + 1) % args.eval_every == 0
             or k + 1 == args.k for k in range(args.k)]
    for h, ev in zip(hist, evals):
        require(all(math.isfinite(h[k]) for k in
                    ("local_loss_mean", "divergence"))
                and (math.isfinite(h["global_loss"]) if ev
                     else math.isnan(h["global_loss"])),
                f"non-finite metrics, or a global loss off the eval stride, "
                f"on the {what}: {h}")
    losses = [h["global_loss"] for h, ev in zip(hist, evals) if ev]
    require(not falling or losses[-1] < losses[0],
            f"global loss did not fall on the {what}: {losses}")
    require(all(math.isfinite(v.float().abs().sum().item())
                for v in state.params.values()),
            f"non-finite params on the {what}")
    syncs = result["host_syncs"] = round_host_syncs(torch, args)
    for key in ("loop", "replays"):
        require(not syncs[key], f"{len(syncs[key])} host syncs in the "
                                f"{key} of the {what}: {syncs[key][:3]}")
    return args, result, state, hist, launches


def phase_main_path(torch, dev, flags, want, what, label):
    """Phases 2 and 2b: a full-width path on the card, through its
    kernels, with no host sync inside its rounds."""
    args, result, state, hist, launches = drive_path(torch, dev, flags, want,
                                                     what)
    require(result["tau"] == 10, f"tau {result['tau']} != 10")
    syncs = result["host_syncs"]
    print(f"phase {label}: host syncs of the graph driver's setup (the "
          f"warm round and the captures; not gated): {len(syncs['setup'])}"
          f" {syncs['setup'][:2]}", flush=True)
    replayed = replay_kernel_counts(
        torch, args, {name: n // args.k for name, n in want.items()}, what)
    print(f"phase {label} ok: " + json.dumps(
        {"path": what, "launches": launches, "dispatch": result["dispatch"],
         "drivers_bitwise_equal": True,
         "global_loss": [h["global_loss"] for h in hist],
         "final_eval_acc": result["final_eval_acc"],
         "ergodic_gap": result["ergodic_gap"],
         "host_syncs_in_loop_rounds": len(syncs["loop"]),
         "host_syncs_in_replays": len(syncs["replays"]),
         "replays_profiled_kernels": replayed,
         "wall_s_first_run": result["wall_s"]}), flush=True)
    return args, result, state, hist, launches


def phase_adversarial(torch, dev):
    """Phase 2c: the adversarial paths at K = 2, on the card. An attack may
    keep the loss from falling, so the falling loss is not required."""
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
             "dispatch": result["dispatch"], "drivers_bitwise_equal": True,
             "host_syncs": {key: len(v) for key, v
                            in result["host_syncs"].items()},
             "global_loss": [h["global_loss"] for h in hist]}), flush=True)


def phase_graph_variants(torch, dev):
    """Phase 2d: VARIANT_ARGS (the rotating shift schedule, eval stride 2,
    K = K_VARIANTS) by both drivers, bitwise equal with exact launch
    counts, no host sync in the loop's rounds nor in the replays, and as
    many graphs as the run has (phase, evaluates) variants in rounds 1 ..
    K - 1: graphs of one pool, replayed out of their capture order."""
    from repro_torch.core import rounds

    what = "rotating schedule, eval stride 2"
    want = {"pow_race": K_VARIANTS, "fedavg_flat": 0, "mix_rows_flat": 0,
            "digest_div_flat": 4 * K_VARIANTS}
    args, result, _, hist, launches = drive_path(torch, dev, VARIANT_ARGS,
                                                 want, what)
    graph = dict(rounds.LAST_GRAPH)
    period = N_CLIENTS - 1
    variants = {(k % period, (k + 1) % 2 == 0 or k + 1 == K_VARIANTS)
                for k in range(1, K_VARIANTS)}
    require(result["dispatch"]["mix_mode"] == "exec_shift_table"
            and graph["graphs"] == len(variants)
            and graph["replays"] == K_VARIANTS - 1,
            f"the {what} ran {result['dispatch']} with {graph}, expected "
            f"exec_shift_table, {len(variants)} graphs and "
            f"{K_VARIANTS - 1} replays")
    print("phase 2d ok: " + json.dumps(
        {"path": what, "launches": launches, "graphs": graph["graphs"],
         "replays": graph["replays"], "drivers_bitwise_equal": True,
         "evaluated_global_loss": [h["global_loss"] for h in hist
                                   if math.isfinite(h["global_loss"])]}),
          flush=True)


def phase_stacked(torch, args, want):
    """Phase 2, stacked batch: the paper's path over a ``[K, C, m / 2,
    ...]`` stack (round k on its own half of each client's samples) through
    ``rounds.run_blade_fl``: by the graph driver (``stacked=True``), by the
    loop driver (``jit=False``) and as a per-round callable over the same
    slices (the loop). The three bitwise equal (params, history, ledger),
    each with the launch counts ``want`` and a valid chain."""
    from repro_torch import kernels
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    batch = src.static_batch()
    m = next(iter(batch.values())).shape[1]
    gen = torch.Generator(device="cpu").manual_seed(args.seed + 7)
    picks = [torch.randperm(m, generator=gen)[:m // 2].to(dev)
             for _ in range(blade.K)]
    stack = {n: torch.stack([v.index_select(1, p) for p in picks])
             for n, v in batch.items()}
    runs = {}
    for how, batches, kw in (
            ("graph", stack, {"stacked": True}),
            ("loop", stack, {"stacked": True, "jit": False}),
            ("callable", lambda k: {n: v[k] for n, v in stack.items()}, {})):
        kernels.reset_launch_counts()
        state, hist, ledger = rounds.run_blade_fl(
            mlp_client_losses, spec, params, batches, blade.K,
            seed=blade.seed + 2, device=dev, **kw)
        torch.cuda.synchronize()
        counts = {n: c for n, c in kernels.launch_counts().items()
                  if n in want}
        driver = rounds.LAST_DISPATCH["driver"]
        require(driver == ("graph" if how == "graph" else "loop")
                and counts == want and ledger.validate_chain()
                and len(ledger.blocks) == blade.K,
                f"stacked batch, {how}: driver {driver}, launches {counts} "
                f"(want {want}), {len(ledger.blocks)} blocks")
        runs[how] = (state, hist, ledger)
    state, hist, ledger = runs["graph"]
    for how in ("loop", "callable"):
        s, h, led = runs[how]
        require(json.dumps(hist) == json.dumps(h)
                and torch.equal(state.prev_hash, s.prev_hash)
                and ledger.head_hash == led.head_hash
                and all(torch.equal(v, s.params[k])
                        for k, v in state.params.items()),
                f"stacked batch: the graph driver and the {how} run differ")
    print("phase 2 ok, stacked batch: " + json.dumps(
        {"batch": {n: list(v.shape) for n, v in stack.items()},
         "launches": want, "graph_loop_callable_bitwise_equal": True,
         "global_loss": [h["global_loss"] for h in hist]}), flush=True)


def replay_kernel_counts(torch, args, per_round, what):
    """Profile the graph driver's K - 1 replays of the path ``args``
    selects and count each FL kernel's launches by its name among the
    device's activities (KERNEL_SYMBOL). Each count must equal the
    launches the driver added to the wrapper's count for the replays, and
    ``per_round`` times K - 1: exactly in one of PROFILE_ATTEMPTS profiles
    (each of a fresh capture; the profiler drops activities now and then
    and never adds one), else with the largest counts seen at most
    PROFILE_DROP_LIMIT activities short in all and none above. Returns
    the counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch import kernels
    from repro_torch.benchmarks import timing
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    batch = src.static_batch()
    want = {name: per_round[name] * (blade.K - 1) for name in KERNEL_SYMBOL}
    best = {name: 0 for name in KERNEL_SYMBOL}
    for attempt in range(timing.PROFILE_ATTEMPTS):
        captured = rounds.CapturedRounds(rounds.RoundRunner(
            mlp_client_losses, spec, params, blade.K, seed=blade.seed + 2,
            device=dev), batch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            captured.replay()
            torch.cuda.synchronize()
        added = {name: kernels.launch_counts()[name]
                 for name in KERNEL_SYMBOL}
        require(added == want, f"the {what}'s replays added the launch "
                               f"counts {added}, expected {want}")
        names = [e.name for e in p.events()
                 if e.device_type == DeviceType.CUDA]
        seen = {name: sum(sym in n for n in names)
                for name, sym in KERNEL_SYMBOL.items()}
        if seen == want:
            return seen
        best = {name: max(best[name], seen[name]) for name in best}
        print(f"replay profile of the {what}: kernels counted by name "
              f"{seen}, want {want} (attempt {attempt + 1})", flush=True)
    short = sum(want[name] - best[name] for name in want)
    require(all(best[name] <= want[name] for name in want)
            and short <= PROFILE_DROP_LIMIT,
            f"the {what}'s replays ran the kernels {best} by the profiler, "
            f"but the launch counts say {want}")
    return best


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
    """The host syncs of the path ``args`` selects, by part of a run (the
    buffers' set-up and the end-of-run transfer left out): ``loop``, the K
    rounds of the loop driver; ``setup``, the graph driver's warm round
    and captures; ``replays``, its K - 1 replays. The design makes none in
    the rounds: the carry, the metrics, the mixing matrices and the noise
    (uploaded before the rounds) and every input of the race stay on the
    device."""
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    batch = src.static_batch()

    def runner():
        return rounds.RoundRunner(mlp_client_losses, spec, params, blade.K,
                                  seed=blade.seed + 2, device=dev)

    loop = runner()
    out = {"loop": host_syncs(torch, lambda: [loop.step(k, batch)
                                              for k in range(blade.K)])}
    graph = runner()
    captured = []
    out["setup"] = host_syncs(torch, lambda: captured.append(
        rounds.CapturedRounds(graph, batch)))
    out["replays"] = host_syncs(torch, captured[0].replay)
    return out


def round_ms(torch, args, profile_dir, tag):
    """ms per round of warm runs of a path by each driver: the trainer's
    host-clock ``wall_s`` (K rounds ending in the one host transfer, the
    ledger and the final eval) over K, for runs in the order loop, graph,
    graph, loop; the graph driver's warm round and captures (host seconds,
    ``rounds.LAST_GRAPH``); and the device memory each graph run added to
    what the allocator reserves (none once the device's side stream and
    graph pool, ``rounds._CaptureHome``, have held a run of this shape).
    With ``profile_dir``, also profile one
    run by each driver, and the graph driver's replays alone, into
    ``profile_rounds_<tag>_<driver>.txt``, and report the device's busy
    share and its operations a round."""
    from repro_torch.core import rounds
    from repro_torch.launch import train

    out = {"loop": [], "graph": [], "graph_setup_s": [],
           "graph_reserved_growth_gb": []}
    for jit in (False, True, True, False):
        reserved = torch.cuda.memory_reserved()
        result, _, _ = train.train_mlp(args, jit=jit)
        out["graph" if jit else "loop"].append(1e3 * result["wall_s"] / K)
        if jit:
            out["graph_setup_s"].append({key: rounds.LAST_GRAPH[key] for key
                                         in ("warm_s", "capture_s")})
            out["graph_reserved_growth_gb"].append(
                (torch.cuda.memory_reserved() - reserved) / 1e9)
    if profile_dir:
        for driver in ("loop", "graph", "replays"):
            out[f"profile_{driver}"] = profile_rounds(
                torch, args, driver, profile_dir, f"{tag}_{driver}")
    return out


def profile_rounds(torch, args, driver, profile_dir, name):
    """Profile the rounds of the path ``args`` selects by ``driver``:
    ``loop`` or ``graph`` (``rounds.run_blade_fl``, set-up and end-of-run
    transfer included), or ``replays`` (the graph driver's K - 1 replays
    alone); write the tables to ``profile_rounds_<name>.txt`` and return
    the host ms, the device's busy ms and share, and device operations a
    round."""
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch.benchmarks import timing
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, src, params, dev = train.prepare_mlp(args)
    batch = src.static_batch()
    captured = None
    if driver == "replays":
        captured = rounds.CapturedRounds(rounds.RoundRunner(
            mlp_client_losses, spec, params, blade.K, seed=blade.seed + 2,
            device=dev), batch)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        if captured is not None:
            captured.replay()
        else:
            rounds.run_blade_fl(mlp_client_losses, spec, params, batch,
                                blade.K, seed=blade.seed + 2, device=dev,
                                jit=driver == "graph")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = timing.device_us(p) / 1e3
    n_rounds = blade.K - 1 if captured is not None else blade.K
    ops = timing.device_ops(p)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"profile_rounds_{name}.txt")
    with open(path, "w") as f:
        for key in ("cuda_time_total", "cpu_time_total"):
            f.write(p.key_averages().table(sort_by=key, row_limit=40))
            f.write("\n")
    print(f"profile {name}: {n_rounds} rounds in {wall_ms:.3f} ms (host "
          f"clock, under the profiler); device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), {ops / n_rounds:g} device "
          f"operations a round; tables in {path}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "rounds": n_rounds,
            "device_ops_a_round": ops / n_rounds}


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


def phase_sweep(torch, dev):
    """Phase 5: the paper's K sweep on the card. ``fig3_bound_gap`` by the
    graph driver and by the loop driver (runs in the order graph, loop,
    loop, graph): its rows, claim flags and both drivers' sweep wall
    times; ``bound_above`` and valid ledgers are required, the gap at the
    optimum (< 0.05 in the paper) and ``k_emp == k_bound`` are printed.
    Then ``sweep_k`` at SWEEP_CARD_CPU_KS on the card against the same
    sweep on the CPU: every loss, the eval loss and the divergence within
    rtol CARD_CPU_RTOL / atol CARD_CPU_ATOL (accuracy printed)."""
    from repro_torch.benchmarks import common, paper_tables

    figs, walls = {}, {"graph": [], "loop": []}
    for driver in ("graph", "loop", "loop", "graph"):
        fig = paper_tables.fig3_bound_gap(device=dev, jit=driver == "graph")
        require(fig["driver"] == driver and fig["chain_valid"],
                f"fig3 sweep by the {driver} driver: driver "
                f"{fig['driver']}, chain_valid {fig['chain_valid']}")
        require(fig["bound_above"], f"fig3 by the {driver} driver: the "
                                    f"bound lies below the experiment: "
                                    f"{fig['rows']}")
        figs.setdefault(driver, fig)
        walls[driver].append({"sweep_s": fig["sweep_s"],
                              "rounds_s": fig["rounds_s"]})
    fig = figs["graph"]
    print("phase 5: fig3 on the card: " + json.dumps(
        {"rows": fig["rows"], "bound_above": fig["bound_above"],
         "k_emp": fig["k_emp"], "k_bound": fig["k_bound"],
         "gap_at_opt": fig["gap"],
         "gap_below_5_percent": fig["gap"] < 0.05,
         "k_emp_equals_k_bound": fig["k_emp"] == fig["k_bound"],
         "drivers_give_equal_rows": fig["rows"] == figs["loop"]["rows"],
         "wall_by_driver": walls}), flush=True)

    card = common.sweep_k(ks=SWEEP_CARD_CPU_KS, device=dev, **FIG3_CONFIG)
    cpu = common.sweep_k(ks=SWEEP_CARD_CPU_KS, device="cpu", **FIG3_CONFIG)
    require([r["k"] for r in card] == [r["k"] for r in cpu]
            == SWEEP_CARD_CPU_KS, "sweep Ks differ between card and cpu")
    worst, acc = {}, {}
    for r, c in zip(card, cpu):
        for key in ("loss_curve", "final_loss", "eval_loss", "divergence"):
            a = torch.as_tensor(r[key], dtype=torch.float64)
            b = torch.as_tensor(c[key], dtype=torch.float64)
            ratio = float(((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                            * b.abs())).max())
            worst[key] = max(worst.get(key, 0.0), ratio)
        acc[r["k"]] = (r["accuracy"], c["accuracy"])
        require(r["chain_valid"] and c["chain_valid"],
                f"sweep at K = {r['k']}: invalid ledger")
    print("phase 5: sweep card vs cpu at K in "
          f"{SWEEP_CARD_CPU_KS} (tau {[r['tau'] for r in card]}), worst "
          f"|diff| / (atol + rtol |cpu|): {json.dumps(worst)}; accuracy "
          f"(card, cpu): {json.dumps(acc)}", flush=True)
    bad = sorted(k for k, v in worst.items() if not v <= 1)
    require(not bad, f"{bad} differ between the card's and the cpu's sweep "
                     f"beyond rtol {CARD_CPU_RTOL} atol {CARD_CPU_ATOL}")
    print(f"phase 5 ok: fig3 bound above the experiment at every K, sweep "
          f"card vs cpu within rtol {CARD_CPU_RTOL} atol {CARD_CPU_ATOL} "
          f"(worst {max(worst.values()):.3g})", flush=True)


def phase_cohort_kernels(torch, dev, report):
    """Phase 6a: the FL kernels at the cohort paths' sizes. At each C of
    COHORT_SIZES and each leaf width: ``fedavg_flat`` (uniform and
    weighted, with and without noise) and ``digest_div_flat`` within
    their tolerances, and the mine kernel in seal mode, bitwise, at two
    nonce offsets. ``mix_rows_flat`` bitwise at MIX_COHORT_BLOCKS x
    MIX_COHORT_WIDTHS (K past the 64 k its stage holds). Then the times of
    ``mix_rows_flat`` at MIX_TIMED and of ``fedavg_flat`` and
    ``digest_div_flat`` at C = COHORT_C over the four leaves, with their
    bounds, added to ``report``'s rows under ``at_cohort``."""
    from repro_torch.benchmarks import timing
    from repro_torch.core import mining
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.pow_hash import ops as pow_ops
    from repro_torch.kernels.pow_hash import ref as pow_ref

    gen = torch.Generator(device=dev).manual_seed(8642)
    fed_err = dig_err = 0.0
    for c in COHORT_SIZES:
        for name, n in LEAF_WIDTHS.items():
            x = torch.randn((c, n), generator=gen, device=dev) + 0.25
            noise = 0.1 * torch.randn((c, n), generator=gen, device=dev)
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            for weights in (torch.full((c,), 1.0 / c, device=dev),
                            (w / w.sum()).contiguous()):
                for nz in (None, noise):
                    got = fedavg_ops.fedavg_flat(x, weights, nz)
                    want = fedavg_ref.fedavg_flat_ref(x, weights, nz)
                    err = (got - want).abs()
                    fed_err = max(fed_err, float(err.max()))
                    require(bool((err <= FLOAT_ATOL + FLOAT_RTOL
                                  * want.abs()).all()),
                            f"fedavg_flat off tolerance at C={c} leaf "
                            f"{name}")
            dig_err = max(dig_err, check_digest(torch, x,
                                                f"C={c} leaf {name}"))
        for off in (5 << 20, (1 << 32) - 77):
            prev, digest, offset = (
                torch.full((), v & mining.MASK, dtype=torch.int64,
                           device=dev)
                for v in (0x2468ACE, 0x13579BD ^ off ^ c, off))
            got = pow_ops.mine_seal(prev, digest, c, MINE_ATTEMPTS,
                                    nonce_offset=offset, difficulty_bits=4)
            want = pow_ref.mine_seal_ref(prev, digest, offset, c,
                                         MINE_ATTEMPTS, 4)
            require(same_seal(torch, got, want),
                    f"mine_seal not bitwise equal at C={c} offset {off}")
    mix_cases = 0
    for r, k in MIX_COHORT_BLOCKS:
        w = torch.rand((r, k), generator=gen, device=dev) + 0.1
        w = w / w.sum(dim=1, keepdim=True)
        for n in MIX_COHORT_WIDTHS:
            x = torch.randn((k, n), generator=gen, device=dev)
            require(torch.equal(fedavg_ops.mix_rows_flat(w, x),
                                fedavg_ref.mix_rows_flat_ref(w, x)),
                    f"mix_rows_flat not bitwise equal to its plain version "
                    f"at R={r} K={k} N={n}")
            mix_cases += 1
            del x
    torch.cuda.empty_cache()

    widths = list(LEAF_WIDTHS.values())
    elems = sum(widths)

    def leaves(rows):
        return [torch.randn((rows, n), generator=gen, device=dev)
                for n in widths]

    timed = {}
    for r, k in MIX_TIMED:
        xs = leaves(k)
        w = torch.rand((r, k), generator=gen, device=dev) + 0.1
        w = w / w.sum(dim=1, keepdim=True)
        timed[f"R{r}xK{k}"] = dict(
            ms=timing.kernel_ms(lambda xs=xs, w=w: [
                fedavg_ops.mix_rows_flat(w, x) for x in xs],
                f"mix_rows_flat R={r} K={k}"),
            library_ms=timing.kernel_ms(lambda xs=xs, w=w: [
                torch.mm(w, x) for x in xs],
                f"mix_rows_flat library (torch.mm) R={r} K={k}"),
            bound_ms=1e3 * max((4 * (k + r) * elems + 16 * r * k)
                               / PEAK_BYTES_S,
                               2 * r * k * elems / PEAK_ALU_OPS_S))
    report["mix_rows_flat"]["at_cohort"] = timed
    c = COHORT_C
    xs = leaves(c)
    u = torch.full((c,), 1.0 / c, device=dev)
    report["fedavg_flat"]["at_cohort"] = {f"C{c}": dict(
        ms=timing.kernel_ms(lambda: [fedavg_ops.fedavg_flat(x, u)
                                     for x in xs], f"fedavg_flat C={c}"),
        bound_ms=1e3 * max((8 * c * elems + 16 * c) / PEAK_BYTES_S,
                           2 * c * elems / PEAK_ALU_OPS_S))}
    report["digest_div_flat"]["at_cohort"] = {f"C{c}": dict(
        ms=timing.kernel_ms(lambda: [fedavg_ops.digest_div_flat(x)
                                     for x in xs], f"digest_div_flat C={c}"),
        bound_ms=1e3 * max((4 * c * elems + 16 * (c + 1)) / PEAK_BYTES_S,
                           4 * c * elems / PEAK_ALU_OPS_S))}
    print(f"phase 6a ok: at C in {COHORT_SIZES} and every leaf, "
          f"fedavg_flat (uniform and weighted, with and without noise) "
          f"within rtol {FLOAT_RTOL} (largest deviation {fed_err:.3g}), "
          f"digest_div_flat within its tolerance (largest deviation "
          f"{dig_err:.3g}), mine_seal x {MINE_ATTEMPTS} bitwise at two "
          f"offsets; mix_rows_flat bitwise "
          f"at {mix_cases} cases ((R, K) in {MIX_COHORT_BLOCKS} x N in "
          f"{MIX_COHORT_WIDTHS}); times " + json.dumps(
              {name: report[name]["at_cohort"] for name in
               ("mix_rows_flat", "fedavg_flat", "digest_div_flat")}),
          flush=True)


def cohort_runner(torch, args):
    """A ``rounds.CohortRunner`` as ``launch.train.train_cohort`` builds
    it for ``args`` (a fresh data source: every client's set still to be
    built), and the run's seed."""
    from repro_torch.core import rounds, topology
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    blade, spec, cohort, src, params, dev = train.prepare_cohort(args)
    seed = blade.seed + 2
    table = topology.round_table(spec.topology, spec.n_clients, blade.K,
                                 topology.topology_generator(seed))
    return rounds.CohortRunner(mlp_client_losses, spec, params,
                               src.cohort_batch, blade.K, cohort, seed=seed,
                               device=dev, topology_matrices=table), seed


def cohort_path(torch, dev, flags, want, what, profile_dir):
    """Phase 6b, one full-width cohort path: the trainer's run with its
    launch counts (``want``) and peak device memory, its ledger, its
    memberships (sorted, distinct, in range, ``topology.cohort_table``
    replayed from the seed) and ``touched``; the host syncs of a run's
    rounds (at most one a round: the scatter); each round's host-clock
    split; the device busy share of a profiled run. Returns (result,
    launches)."""
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch import kernels
    from repro_torch.benchmarks import timing
    from repro_torch.core import topology
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    result, store, hist = train.train_cohort(args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == want, f"launch counts {launches} on the {what}, "
                              f"expected {want}")
    require(result["chain_valid"] and result["blocks"] == args.k
            and result["dispatch"]["driver"] == "cohort",
            f"the {what}: {result}")
    cohorts = [h["cohort"] for h in hist]
    schedule = topology.CohortSchedule.from_spec(args.enrolled, args.cohort,
                                                 args.cohort_bias)
    require(all(len(c) == args.cohort and all(0 <= a < b < args.enrolled
                                               for a, b in zip(c, c[1:]))
                and 0 <= c[0] for c in cohorts)
            and cohorts == topology.cohort_table(schedule, args.k,
                                                 args.seed + 2).tolist(),
            f"the {what}'s memberships are not the seed's sorted, distinct "
            f"draws: {cohorts}")
    touched = len({i for c in cohorts for i in c})
    require(result["touched"] == store.touched == touched,
            f"the {what} touched {result['touched']}, its cohorts hold "
            f"{touched} clients")
    require(all(math.isfinite(h[key]) for h in hist
                for key in ("local_loss_mean", "global_loss", "divergence")),
            f"non-finite metrics on the {what}")
    require(peak_gb < COHORT_PEAK_GB, f"the {what} peaked at {peak_gb:.3f} "
                                      f"GB of device memory (limit "
                                      f"{COHORT_PEAK_GB})")
    runner, _ = cohort_runner(torch, args)
    syncs = host_syncs(torch, lambda: [runner.step(k)
                                       for k in range(args.k)])
    require(len(syncs) <= args.k, f"{len(syncs)} host syncs in the "
                                  f"{args.k} rounds of the {what}: "
                                  f"{syncs[:3]}")
    runner, _ = cohort_runner(torch, args)
    split = []
    for k in range(args.k):
        t = [time.perf_counter()]
        batch = runner.batch(k)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        runner.load(k)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        runner.runner.step(k, batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        runner.store_back(k)
        t.append(time.perf_counter())
        split.append({part: 1e3 * (b - a) for part, a, b in zip(
            ("data_build_ms", "gather_upload_ms", "device_round_ms",
             "scatter_ms"), t, t[1:])})
    runner, _ = cohort_runner(torch, args)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for k in range(args.k):
            runner.step(k)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = timing.device_us(p) / 1e3
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"profile_cohort_A{args.cohort}.txt")
        with open(path, "w") as f:
            f.write(p.key_averages().table(sort_by="cuda_time_total",
                                           row_limit=40))
    print(f"phase 6b ok: " + json.dumps(
        {"path": what, "launches": launches, "dispatch": result["dispatch"],
         "touched": touched, "store_mb": result["store_mb"],
         "global_loss": [h["global_loss"] for h in hist],
         "final_eval_acc": result["final_eval_acc"],
         "peak_allocated_gb": peak_gb, "allocated_before_gb": base_gb,
         "host_syncs_in_rounds": len(syncs), "wall_s": result["wall_s"],
         "round_split_ms": split,
         "profiled_rounds": {"wall_ms": wall_ms, "busy_ms": busy_ms,
                             "busy_share": busy_ms / wall_ms,
                             "device_ops_a_round":
                                 timing.device_ops(p) / args.k}}),
          flush=True)
    return result, launches


def phase_degenerate_cohort(torch, dev):
    """Phase 6c: DEGENERATE_ARGS (20 enrolled, a cohort of 20, ``prefix``)
    by the cohort driver, against ``rounds.run_blade_fl``'s loop on the
    same spec, params, data, seed and matrices: params, every metric and
    the ledger bitwise equal."""
    import numpy as np

    from repro_torch.core import rounds, topology
    from repro_torch.launch import train
    from repro_torch.models.mlp import mlp_client_losses

    args = train.build_parser().parse_args(DEGENERATE_ARGS
                                           + ["--device", str(dev)])
    blade, spec, cohort, src, params, dev = train.prepare_cohort(args)
    seed = blade.seed + 2
    table = topology.round_table(spec.topology, spec.n_clients, blade.K,
                                 topology.topology_generator(seed))
    store, chist, cledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, spec, params, src.cohort_batch, blade.K, cohort,
        seed=seed, device=dev, topology_matrices=table)
    everyone = np.arange(args.enrolled)
    state, lhist, lledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.cohort_batch(0, everyone),
        blade.K, seed=seed, device=dev, jit=False, topology_matrices=table)
    final = store.gather(everyone)
    require(all(h.pop("cohort") == everyone.tolist() for h in chist)
            and json.dumps(chist) == json.dumps(lhist)
            and [b.header_hash for b in cledger.blocks]
            == [b.header_hash for b in lledger.blocks]
            and all(torch.equal(final[k], v)
                    for k, v in state.params.items()),
            "the degenerate cohort differs from the loop driver")
    print("phase 6c ok: the degenerate cohort (20 of 20, prefix) bitwise "
          "equal to the loop driver (params, every metric, ledger hashes "
          f"{cledger.head_hash:#010x})", flush=True)


def phase_cohort_card_vs_cpu(torch, dev):
    """Phase 6d: COHORT_CPU_ARGS on the card and on the CPU, per topology
    of COHORT_CPU_TOPOLOGIES: the memberships equal; every per-round
    metric, the eval loss and the last cohort's aggregate within rtol
    CARD_CPU_RTOL / atol CARD_CPU_ATOL; every touched client's row within
    it on a consensus mix, else within CLIENT_SPREAD_LIMIT times it."""
    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.launch import train

    def ratio(a, b):   # |a - b| over the tolerance at b; <= 1 passes
        a = torch.as_tensor(a, dtype=torch.float64).cpu()
        b = torch.as_tensor(b, dtype=torch.float64)
        return float(((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                       * b.abs())).max())

    out = {}
    for topo, consensus in COHORT_CPU_TOPOLOGIES:
        flags = COHORT_CPU_ARGS + ["--topology", topo]
        if not consensus:
            flags += ["--fused-mix"]
        (result, store, hist), (cresult, cstore, chist) = (
            train.train_cohort(train.build_parser().parse_args(
                flags + ["--device", device]), samples=COHORT_CPU_SAMPLES)
            for device in (str(dev), "cpu"))
        cohorts = [h["cohort"] for h in hist]
        require(cohorts == [h["cohort"] for h in chist],
                f"cohort card vs cpu ({topo}): memberships differ")
        gated = {key: max(ratio(a[key], b[key]) for a, b in zip(hist, chist))
                 for key in ("local_loss_mean", "global_loss", "divergence")}
        gated["final_eval_loss"] = ratio(result["final_eval_loss"],
                                         cresult["final_eval_loss"])
        touched = np.array(sorted({i for c in cohorts for i in c}))
        rows, crows = store.gather(touched), cstore.gather(touched)
        last = np.array(cohorts[-1])
        agg = aggregation.aggregate_once(store.gather(last))
        cagg = aggregation.aggregate_once(cstore.gather(last))
        for name, v in agg.items():
            gated[f"aggregate {name}"] = ratio(v, cagg[name])
        limit = 1.0 if consensus else CLIENT_SPREAD_LIMIT
        clients = {f"client {name}": ratio(v, crows[name])
                   for name, v in rows.items()}
        bad = sorted(k for k, r in gated.items() if not r <= 1)
        bad += sorted(k for k, r in clients.items() if not r <= limit)
        require(not bad, f"cohort card vs cpu ({topo}): {bad} beyond rtol "
                         f"{CARD_CPU_RTOL} atol {CARD_CPU_ATOL} (rows: "
                         f"{limit} times): {gated} {clients}")
        out[topo] = {"worst_gated": max(gated.values()),
                     "worst_client_row": max(clients.values()),
                     "row_limit": limit, "touched": len(touched)}
    print("phase 6d ok: cohort card vs cpu (1000 enrolled, cohort 16, K = "
          f"3, {COHORT_CPU_SAMPLES} samples), worst |diff| / (atol + rtol "
          "|cpu|): "
          + json.dumps(out), flush=True)


def phase_cohort(torch, dev, report, profile_dir):
    """Phase 6, the cohort path: 6a its kernels at its sizes, 6b the two
    full-width runs, 6c the degenerate cohort, 6d card against CPU.
    Returns the launch counts of the two 6b runs."""
    phase_cohort_kernels(torch, dev, report)
    torch.cuda.empty_cache()
    k = K
    _, launches = cohort_path(
        torch, dev, COHORT_ARGS,
        {"pow_race": k, "fedavg_flat": 4 * k, "digest_div_flat": 4 * k},
        "cohort path (64 of 10 000)", profile_dir)
    _, dlaunches = cohort_path(
        torch, dev, COHORT_DENSE_ARGS,
        {"pow_race": k, "mix_rows_flat": 4 * k, "digest_div_flat": 4 * k},
        "dense cohort path (128 of 10 000, random:0.5, fused mix)",
        profile_dir)
    phase_degenerate_cohort(torch, dev)
    phase_cohort_card_vs_cpu(torch, dev)
    return launches, dlaunches


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

    from repro_torch.benchmarks import timing
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
        ms=timing.kernel_ms(flash, "flash_attention", reps=10),
        call_ms=timing.time_ms(flash, reps=10, warmup=2),
        plain_ms=timing.kernel_ms(lambda: flash_ref.mha_ref(
            q, k, v, causal=True), "flash_attention plain", reps=3),
        library_ms=timing.kernel_ms(sdpa, "flash_attention library (SDPA)",
                             reps=10),
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
        ms=timing.kernel_ms(scan, "ssm_scan", reps=10),
        call_ms=timing.time_ms(scan, reps=10, warmup=2),
        plain_ms=timing.kernel_ms(lambda: ssm_ref.ssm_scan_ref(
            u, dt, bm, cm, a, dsk), "ssm_scan plain", reps=2),
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


def kernel_table(report, by_path):
    """The rows of the kernel table: each kernel's report, its source, the
    TPU kernel it replaces, its launches on its main path (and on every
    path), and its CUDA-event time where the report has none."""
    from repro_torch.benchmarks import timing
    from repro_torch.kernels import _build

    table = []
    for name in REPLACES:
        row = {"name": name, "route": "cuda",
               "source": os.path.relpath(_build.SOURCES[LIBRARY[name]], ROOT),
               "replaces": REPLACES[name],
               "launches": by_path[MAIN_PATH_OF[name]][name],
               "launched_by": LAUNCHED_BY[MAIN_PATH_OF[name]],
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               **report[name]}
        if "events_ms" not in row:
            row["events_ms"] = timing.READINGS[name]["events_ms"]
        table.append(row)
    return table


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
    phase_stacked(torch, args, paper)
    topo = {"pow_race": K, "fedavg_flat": 0, "mix_rows_flat": 4 * K,
            "digest_div_flat": 4 * K}
    targs, tresult, tstate, thist, tlaunches = phase_main_path(
        torch, dev, TOPOLOGY_ARGS, topo, "topology path", "2b")
    require(tresult["dispatch"]["mix_mode"] == "exec_gather"
            and tresult["dispatch"]["pow"] == "kernel",
            f"topology path dispatch {tresult['dispatch']}")
    phase_adversarial(torch, dev)
    phase_graph_variants(torch, dev)
    for tag, a in (("paper", args), ("topology", targs)):
        print(f"round_ms, {tag} path (ms per round, host clock, warm runs "
              f"of K = {K} at C = {N_CLIENTS}, by driver): " + json.dumps(
                  round_ms(torch, a, opts.profile, tag)), flush=True)
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
    phase_sweep(torch, dev)
    lap("phase 5")
    clau, dclau = phase_cohort(torch, dev, report, opts.profile)
    lap("phase 6")

    by_path = {"paper": launches, "topology": tlaunches, "serve": slaunches,
               "cohort": clau, "dense cohort": dclau}
    flag_readings()
    table = kernel_table(report, by_path)
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
