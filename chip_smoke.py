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
1b. the same for the serve paths' kernels, ``flash_attention`` (at both
   paths' attention shapes, Jamba's GQA at D 128 and DeepSeek's MLA at B
   4, H = Hkv = 128, S 2048, D 192, its row timed at the latter; the
   reference's test shapes, ragged S, head dims 36 / 112 / 132 / 192 (the
   kernel's NC = 3 form, ragged and under GQA) / 256, a window, a
   bidirectional mask (HuBERT's path shape, D 80, among them), GQA, bf16,
   and fp32 views too misaligned for its cp.async staging; the prefix-LM
   form at PaliGemma's path shape (prefix 256, MQA at D 256), at ragged S
   with prefixes off both tiles, a prefix of S and past it, a prefix with
   a window, bf16; prefix 0 (the default: determinism) and 1 (through
   the prefix tests) bitwise the causal call; its times at
   both new path shapes beside SDPA with the same mask) and
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
4c. ``launch.serve --arch deepseek-v2-236b --size one-h100`` at the same
   batch, prompt and gen (DeepSeek-V2 at its published widths, the dense
   first layer and three MoE layers of 160 experts, MLA throughout: 13.14
   G parameters): one prefill launches ``flash_attention`` 4 times (D
   192) and no other kernel; the share of the prefill's top-6 choices
   the capacity dropped is printed;
4d. on the same full-width params with the capacity out of the way
   (nothing dropped, asserted), prefill + 8 decode steps (MLA absorbed)
   against one forward (MLA materialized) within ``AGREE_LIMIT``, no host
   sync in decode; one MoE and one MLA layer on 256 tokens, card against
   CPU within rtol 1e-4 / atol 1e-5, and ``moe.route`` on both devices
   equal on the card's router logits. Under ``--profile`` the Jamba and
   the DeepSeek prefill are profiled, device time by class (GEMMs, flash,
   scan, MoE routing and dispatch, other);
4e. ``launch.serve --arch xlstm-125m --size one-h100`` (the published
   config, 0.22 G parameters) at the same batch, prompt and gen: no
   kernel launch (xLSTM runs none); prefill of 2040 tokens and 8 decode
   steps against one forward over 2048 within ``AGREE_LIMIT``, no host
   sync in decode; one mLSTM and one sLSTM layer card against CPU within
   rtol 1e-4 / atol 1e-5; a warm prefill's seconds, and in one more each
   block kind's share (the sLSTM time loops');
4f. ``launch.serve --arch paligemma-3b --size one-h100`` (the published
   config, 2.51 G parameters; 256 patches and 1792 text tokens): 18 flash
   launches a prefill under the prefix-LM mask; prefill + 8 decode steps
   against the forward, no host sync in decode; one attention layer under
   the prefix-LM mask card against CPU;
4g. hubert-xlarge's encoder (the published config, 0.95 G parameters)
   and its codebook head over 4 x 2048 frames, half of them replaced by
   the mask embedding: 48 flash launches (bidirectional, D 80), finite
   logits, seconds and peak memory; one attention layer card against
   CPU. Under ``--profile`` 4e and 4f also profile 4 decode steps, and
   4e-4g one prefill (device ops, busy share, time by class);
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
   to the loop driver; 6d 1 000 enrolled, cohort 16, card against CPU;
7. LM training on the card (``launch.train --arch``): 7a the two backward
   kernels against autograd through their plain twins on the same CUDA
   inputs with a random cotangent: ``mha`` under grad (``_FlashFn``: the
   forward with its rows' logsumexp, then ``flash_attention_bwd.cu``) at
   FLASH_GRAD_CASES (phi4-mini's training shape, MLA's D 192, PaliGemma's
   prefix-LM MQA at D 256, HuBERT's bidirectional D 80, a window, ragged
   S, D 36, MQA) and ``ssm_scan`` under grad (``_ScanFn``: the forward
   with its chunk states, then ``ssm_scan_bwd.cu``) at SSM_GRAD_CASES
   (Jamba's layer shape with a final-h cotangent, ragged T, ds 1 and 64,
   an underflowing decay), each gradient within FLASH_GRAD_* / SSM_GRAD_*
   (the worst share printed), two calls bitwise equal, the forward
   bitwise the serving launch; 7b the backward kernels' times at those
   two path shapes beside the plain twins' autograd and SDPA's fp32
   backward, each with its ratio to its bound, flash's to SDPA's
   backward and each launch's share by name, and ``fedavg_flat`` and
   ``digest_div_flat`` (tolerance) and
   the seal (bitwise) at C = 4 on every xLSTM-125M leaf and on phi4-mini's
   615 M-float embedding, with their times; 7c xLSTM-125M at its
   published widths cut to one period of its pattern (3 mLSTM + 1 sLSTM,
   XLSTM_TRAIN_LAYERS), 4 clients of 2 x 256 tokens, K = 3, one lazy
   client, by both drivers: bitwise equal, launch counts exact (the seal
   K times, ``fedavg_flat`` and ``digest_div_flat`` once a leaf a round,
   flash, scan and mix never), no host sync in the loop's rounds nor in
   the replays, a valid chain, finite losses; the ms a round by each
   driver and a replay's, the warm round's and the captures' seconds,
   the peak device memory and, under ``--profile``, the replays' busy
   share and device operations a round; 7d the xLSTM smoke config with 2
   microbatches a client at K = 2 by both drivers, bitwise, and card
   against CPU; 7e phi4-mini-3.8B at its published widths cut to 2
   layers (0.816 G parameters), 2 clients of 2 x 512 tokens, K = 2, by
   both drivers in the same way, flash forward and backward launch counts
   exact, its peak under PHI4_PEAK_GB; 7f every smoke arch with attention
   or Mamba (SMOKE_TRAIN_ARCHS) trained on the card by the graph driver,
   its flash and scan launches (forward and backward) as its layer
   pattern gives them, held to its CPU run;
8. the client-sharded engine (``launch.train --devices``), one process a
   rank. NCCL refuses two ranks on one card, so several ranks share the
   card over gloo (CUDA tensors; its sends and receives staged through
   pinned host buffers) and run the loop driver, their kernels on the
   card: 8a the paper's path over 2 ranks, gather tier, through the
   trainer's own spawn, each rank's launches exact (the race at C/D = 10,
   the FedAvg kernel and the sweep on the gathered 20), held to the
   one-process loop run, with each rank's round ms, the analytic bytes it
   received a round and each collective's transport; 8b over the same 2
   ranks in one world the Ring(1) halo, the rotation's shift halo,
   ``random:0.5 --fused-mix`` (``mix_rows_flat`` at R = 10, K = 20), the
   psum tier on FullMesh and on ``random:0.5 --fused-mix``
   (``mix_rows_flat`` at R = 20, K = 10), the cohort path (64 of 10 000),
   Jamba smoke trained by ``--arch`` (flash and the scan forward and
   backward on each rank) against its run over 1 rank, then
   ``--clusters 2`` on 4 ranks (2 pods of 2); each path held to its
   one-process run bitwise or, where the local-training GEMMs at C/D
   clients differ in the last bits, at rtol 1e-4 / atol 1e-5 (per-client
   params at CLIENT_SPREAD_LIMIT off consensus), which of the two printed;
   8c the paper's path over 1 NCCL rank on the graph driver, its
   collectives captured in the CUDA graph, bitwise the one-process graph
   run. gloo ranks sharing one card measure no multi-GPU communication.

The last three lines of its output are the kernel table as JSON, the
card's name and power limit, and ``{"ok": true, "device": ...}``. It
exits non-zero, and prints no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
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
              (3, 1, None), (100, 20000, None),
              # phase 8's ranks: C/D = 10 and 5 of the paper's 20, 32 of a
              # cohort of 64, 2 of the smoke archs' 4 clients at 256
              (10, MINE_ATTEMPTS, None), (5, MINE_ATTEMPTS, None),
              (32, MINE_ATTEMPTS, None), (2, 256, None)]
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
# phase 4c: DeepSeek-V2 at its published widths cut to one H100
# (configs/deepseek_v2_236b.py ONE_H100: the dense first layer and three
# MoE layers of 160 experts, MLA in all four), the same prompt and batch
MLA_SERVE_ARGS = ["--arch", "deepseek-v2-236b", "--size", "one-h100",
                  "--batch", "4", "--prompt-len", "2048", "--gen", "32"]
MLA_SERVE_LAUNCHES = {"flash_attention": 4, "ssm_scan": 0}   # one prefill
# phase 4d: on a copy of the config whose capacity drops nothing at this
# size (capacity factor 8, as the reference's decode-consistency tests
# take it: 316 slots an expert for 1056 tokens' 6336 choices), prefill of
# MLA_AGREE_PREFILL tokens and AGREE_STEPS teacher-forced decode steps
# against one forward over all of them; then one MoE layer and one MLA
# layer on LAYER_TOKENS tokens, card against CPU
UNCAPPED_FACTOR = 8.0
MLA_AGREE_PREFILL = 256
LAYER_TOKENS = 256
LAYER_RTOL, LAYER_ATOL = 1e-4, 1e-5
# phases 4e-4g: the three published configs that fit one H100 whole, at the
# same batch and prompt (PaliGemma's prompt: 256 image patches and 1792
# text tokens; HuBERT's: 2048 frames, encoder only, no decode)
XLSTM_SERVE_ARGS = ["--arch", "xlstm-125m", "--size", "one-h100",
                    "--batch", "4", "--prompt-len", "2048", "--gen", "32"]
VLM_SERVE_ARGS = ["--arch", "paligemma-3b", "--size", "one-h100",
                  "--batch", "4", "--prompt-len", "2048", "--gen", "32"]
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES = "hubert-xlarge", 4, 2048
XLSTM_SERVE_LAUNCHES = {"flash_attention": 0, "ssm_scan": 0}
VLM_SERVE_LAUNCHES = {"flash_attention": 18, "ssm_scan": 0}   # one prefill
AUDIO_LAUNCHES = {"flash_attention": 48, "ssm_scan": 0}       # one forward
# 4e's prefill + decode check: prefill of 2040 tokens (chunkwise mLSTM in
# 17 chunks of 120) and AGREE_STEPS decode steps against one forward over
# 2048 (16 chunks of 128); a forward over 2056 would run the sequential
# mLSTM (2056 has no divisor in [16, 128])
XLSTM_AGREE_PREFILL = 2040
# 4g: the share of frames replaced by the mask embedding (i.i.d. here;
# HuBERT masks spans covering about half the frames)
AUDIO_MASK_SHARE = 0.5
# the flash kernel at the serve paths' attention shapes: B, H, Hkv, S, D;
# MLA runs it at hd + rope = 192, the kernel's NC = 3 form (dpad 129-192)
FLASH_PATH = (4, 64, 8, 2048, 128)
FLASH_MLA_PATH = (4, 128, 128, 2048, 192)
# PaliGemma's (prefix-LM mask, prefix 256, MQA at D 256, the NC = 4 form)
# and HuBERT's (bidirectional, D 80)
FLASH_VLM_PATH, FLASH_VLM_PREFIX = (4, 8, 1, 2048, 256), 256
FLASH_AUDIO_PATH = (4, 16, 16, 2048, 80)
# (B, H, Hkv, S, D, causal, window, bf16): the path shapes; the reference's
# FLASH_CASES (tests/test_kernels.py); ragged S; the zoo's odd head dims
# (minicpm 36, kimi 112), the MLA path's 192 ragged and under GQA, the
# NC = 3 form's lowest (132) and the largest (256); a window; a ragged
# bidirectional mask; GQA throughout; bf16 at a small and the path shape
FLASH_CASES = [
    FLASH_PATH + (True, 0, False), FLASH_MLA_PATH + (True, 0, False),
    (1, 8, 8, 777, 192, True, 0, False), (2, 4, 2, 333, 192, True, 0, False),
    (1, 4, 4, 300, 132, True, 0, False),
    (2, 4, 4, 256, 64, True, 0, False), (1, 2, 2, 128, 32, False, 0, False),
    (2, 2, 2, 256, 64, True, 64, False), (1, 1, 1, 512, 128, True, 0, False),
    (1, 2, 2, 128, 16, True, 32, False),
    (1, 8, 2, 1000, 128, True, 0, False), (1, 8, 2, 2056, 128, True, 0, False),
    (2, 4, 2, 300, 36, True, 0, False), (2, 4, 2, 300, 112, True, 0, False),
    (1, 4, 1, 300, 256, True, 0, False),
    (2, 4, 4, 1000, 64, True, 128, False), (2, 4, 2, 777, 64, False, 0, False),
    (1, 2, 2, 128, 64, True, 0, True), FLASH_PATH + (True, 0, True),
    FLASH_AUDIO_PATH + (False, 0, False), (2, 4, 4, 300, 80, False, 0, False),
]
# the prefix-LM form, all causal: (B, H, Hkv, S, D, window, prefix, bf16):
# the VLM path's shape; prefixes off both tiles at ragged S (100, 300); a
# prefix of S and one past it (the whole square); a prefix with a window;
# a prefix of one (the causal mask itself); bf16
FLASH_PREFIX_CASES = [
    FLASH_VLM_PATH + (0, FLASH_VLM_PREFIX, False),
    (2, 4, 2, 777, 64, 0, 100, False), (1, 8, 1, 1000, 256, 0, 300, False),
    (2, 4, 4, 333, 128, 0, 300, False), (1, 4, 2, 300, 80, 0, 300, False),
    (1, 4, 2, 300, 192, 0, 305, False), (2, 4, 2, 700, 64, 128, 300, False),
    (1, 2, 1, 257, 256, 64, 100, False), (2, 2, 2, 200, 32, 0, 1, False),
    (2, 8, 1, 600, 256, 0, 256, True),
]
# causal shapes at which the call with no prefix must equal, bit for bit,
# the call given prefix 0 (the wrapper's default: the same launch, so this
# shows only that the kernel is deterministic) and prefix 1 (the causal
# mask itself, reached through the prefix form's tests). That prefix 0
# keeps the parent kernel's bits is ``bench_kernels --against``'s check.
FLASH_PREFIX_CAUSAL = [FLASH_PATH, (2, 8, 1, 600, 256), (1, 4, 2, 300, 80)]
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
    # no TPU counterpart: the gradients of the two kernels above
    "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:82 "
                           "flash_attention (its gradient; no TPU kernel)",
    "ssm_scan_bwd": "src/repro/kernels/ssm_scan/kernel.py:49 ssm_scan (its "
                    "gradient; no TPU kernel)",
}
# kernel -> the shared library (kernels/_build.py SOURCES) that holds it
LIBRARY = {"pow_race": "pow_race", "fedavg_flat": "fedavg",
           "digest_div_flat": "fedavg", "mix_rows_flat": "fedavg",
           "flash_attention": "flash_attention",
           "flash_attention_bwd": "flash_attention_bwd",
           "ssm_scan": "ssm_scan", "ssm_scan_bwd": "ssm_scan_bwd"}
# kernel -> the path whose run gives its launch count in the table (flash:
# the DeepSeek serve path, at whose shape its row is timed; the flash
# backward: phi4-mini's training path; the scan backward: Jamba smoke's)
MAIN_PATH_OF = {"pow_race": "paper", "fedavg_flat": "paper",
                "digest_div_flat": "paper", "mix_rows_flat": "topology",
                "flash_attention": "mla serve", "ssm_scan": "serve",
                "flash_attention_bwd": "phi4 train",
                "ssm_scan_bwd": "jamba-1.5-large-398b smoke train"}
# path -> what launched its kernels in the counted run: the FL paths' static
# batch runs on the graph driver (a warm round and K - 1 replays, the
# replays' launches added by the driver); the serve paths call the wrappers
LAUNCHED_BY = {"paper": "graph driver", "topology": "graph driver",
               "xlstm train": "graph driver", "phi4 train": "graph driver",
               "jamba-1.5-large-398b smoke train": "graph driver",
               "serve": "eager calls", "mla serve": "eager calls",
               "xlstm serve": "eager calls", "vlm serve": "eager calls",
               "audio encoder": "eager calls"}
# phase 5: the paper's K sweep in Fig. 3's configuration
# (paper_tables.fig3_bound_gap), and the Ks held card against CPU: tau 10,
# 6 and 1, at most 60 local steps a run
FIG3_CONFIG = dict(eta=0.005, alpha=1.0, beta=6.0, t_sum=100.0)
SWEEP_CARD_CPU_KS = [6, 8, 14]
# the (R, K) blocks mix_rows_flat is held to its plain version at: the
# main path's full W, a row block, a column block, the largest it takes,
# and phase 8's two ranks' blocks (the gather tier's rows R = C/D, the
# psum tier's columns K = C/D)
MIX_BLOCKS = [(N_CLIENTS, N_CLIENTS), (5, N_CLIENTS), (N_CLIENTS, 5),
              (64, 64), (N_CLIENTS // 2, N_CLIENTS),
              (N_CLIENTS, N_CLIENTS // 2)]
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

# phase 7: LM training on the card (launch/train.py --arch): xLSTM-125M at
# its published widths (configs/xlstm_125m.py ONE_H100: nothing cut, 0.22 G
# parameters), C = 4 clients of 2 sequences of 256 tokens, K = 3 rounds, one
# lazy client (sigma2 1e-4), FullMesh, the reference's run_arch_smoke round
# (tau 2, eta 1e-2, 256 attempts, difficulty 2)
K_TRAIN = 3
TRAIN_CLIENTS = 4
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-125m", "--size", "one-h100",
                    "--clients", str(TRAIN_CLIENTS), "--per-client", "2",
                    "--seq", "256", "--rounds", str(K_TRAIN), "--lazy", "1",
                    "--sigma2", "1e-4"]
# 7c runs the published widths at one period of the pattern (3 mLSTM + 1
# sLSTM, the first 4 of the 12 layers): one sLSTM time loop, not three
XLSTM_TRAIN_LAYERS = 4
# 7d: the smoke config, each client's batch in 2 microbatches, by both
# drivers and against the CPU
K_TRAIN_SMOKE = 2
XLSTM_MB_ARGS = ["--arch", "xlstm-125m", "--size", "smoke", "--clients",
                 str(TRAIN_CLIENTS), "--per-client", "2", "--seq", "32",
                 "--rounds", str(K_TRAIN_SMOKE), "--lazy", "1", "--sigma2",
                 "1e-4", "--microbatches", "2"]
# 7a: each backward kernel held to autograd through its plain twin on the
# same CUDA inputs with a random cotangent, each gradient tensor at
# |got - want| <= rtol |want| + atol max|want|: flash's lse and D come from
# the forward's 3xTF32 products (held at 3e-5), the scan recomputes its
# decays with ex2.approx as the forward does (held at SSM_ATOL)
FLASH_GRAD_RTOL, FLASH_GRAD_ATOL = 1e-4, 1e-4
SSM_GRAD_RTOL, SSM_GRAD_ATOL = 1e-4, 2e-5
# flash (B, H, Hkv, S, D, causal, window, prefix): phi4-mini's training
# shape (2 x 512 tokens a client); MLA's D 192; PaliGemma's prefix-LM MQA
# at D 256 (prefix 256, its patches); HuBERT's bidirectional D 80; a
# window; ragged S (100, 300); minicpm's D 36; MQA
FLASH_TRAIN_PATH = (2, 24, 8, 512, 128)
FLASH_GRAD_CASES = [
    FLASH_TRAIN_PATH + (True, 0, 0), (1, 16, 16, 512, 192, True, 0, 0),
    (1, 8, 1, 512, 256, True, 0, 256), (1, 16, 16, 512, 80, False, 0, 0),
    (1, 8, 2, 384, 64, True, 96, 0), (1, 4, 2, 100, 64, True, 0, 0),
    (1, 4, 2, 300, 64, True, 0, 0), (2, 4, 2, 256, 36, True, 0, 0),
    (1, 8, 1, 256, 64, True, 0, 0)]
# scan (B, T, d_in, ds, dt scale), each with a non-zero final-h
# cotangent: Jamba's layer shape; ragged T (off the 16-step chunks); ds 1
# and 64; dt large enough that exp(dt a) underflows to 0 (a as Jamba's
# -exp(a_log), a_log = log(1..ds))
SSM_TRAIN_PATH = (2, 512, 16384, 16)
SSM_GRAD_CASES = [SSM_TRAIN_PATH + (1.0,), (2, 100, 256, 16, 1.0),
                  (1, 64, 512, 1, 1.0), (1, 64, 512, 64, 1.0),
                  (1, 64, 256, 16, 60.0)]
# 7e: phi4-mini-3.8B at its published widths cut to 2 layers
# (configs/phi4_mini_3_8b.py ONE_H100: 0.816 G parameters), C = 2 clients
# of 2 sequences of 512 tokens, K = 2 rounds, one lazy client, the same
# round. At C = 4 the warm round ran out of the card's 80 GB (on an H100,
# 66 GiB allocated when the embedding's 9.2 GiB [4, 200 064, 3072]
# gradient was asked for), so the cut is in clients, never a width; a peak
# of allocated memory above PHI4_PEAK_GB fails the phase
K_PHI4 = 2
PHI4_CLIENTS = 2
PHI4_TRAIN_ARGS = ["--arch", "phi4-mini-3.8b", "--size", "one-h100",
                   "--clients", str(PHI4_CLIENTS), "--per-client", "2",
                   "--seq", "512", "--rounds", str(K_PHI4), "--lazy", "1",
                   "--sigma2", "1e-4"]
PHI4_PEAK_GB = 70.0
PHI4_EMBED = 200_064 * 3072   # floats of its widest leaf, the embedding
# 7f: every smoke arch whose forward launches flash or the scan, trained on
# the card by the graph driver and held to its CPU run
SMOKE_TRAIN_ARCHS = ["phi4-mini-3.8b", "qwen3-32b", "nemotron-4-15b",
                     "minicpm-2b", "jamba-1.5-large-398b", "deepseek-v2-236b",
                     "kimi-k2-1t-a32b", "paligemma-3b", "hubert-xlarge"]
SMOKE_TRAIN_ARGS = ["--size", "smoke", "--clients", str(TRAIN_CLIENTS),
                    "--per-client", "2", "--seq", "32", "--rounds",
                    str(K_TRAIN_SMOKE), "--lazy", "1", "--sigma2", "1e-4"]


# phase 8: the client-sharded engine (launch/train.py --devices) on the
# card. NCCL refuses two ranks on one device, so several ranks run over
# gloo (CUDA tensors; gloo's sends and receives staged through pinned host
# buffers, launch/mesh.py), each rank's kernels on the card; one rank runs
# over NCCL, whose collectives the graph driver captures
SHARD_RANKS = 2
SHARD_GLOO = ["--devices", str(SHARD_RANKS), "--backend", "gloo"]
# 8b, each over the same 2 gloo ranks (one world): (flags, consensus) and
# the launches a rank makes a round
SHARDED_PATHS = {
    "paper's path (warm ranks)": (MAIN_ARGS, True,
                                  {"pow_race": 1, "fedavg_flat": 4,
                                   "digest_div_flat": 4}),
    "ring halo": (RING_ARGS, False,
                  {"pow_race": 1, "digest_div_flat": 4}),
    "rotation shift halo": (MAIN_ARGS + ["--schedule", "rotate"], False,
                            {"pow_race": 1, "digest_div_flat": 4}),
    "random:0.5 fused gather (R = C/D, K = C)": (
        TOPOLOGY_ARGS, False,
        {"pow_race": 1, "digest_div_flat": 4, "mix_rows_flat": 4}),
    "psum FullMesh": (MAIN_ARGS + ["--fast-allreduce"], True,
                      {"pow_race": 1}),
    "psum random:0.5 fused (R = C, K = C/D)": (
        TOPOLOGY_ARGS + ["--fast-allreduce"], False,
        {"pow_race": 1, "mix_rows_flat": 4}),
}
# 8b: a cluster topology on 4 ranks as 2 pods of 2 (clusters of 10 clients,
# 5 a rank)
CLUSTER_ARGS = MAIN_ARGS + ["--devices", "4", "--clusters", "2",
                            "--backend", "gloo"]
# 8b: the cohort path, a cohort of 64 of 10 000 enrolled over the 2 ranks
SHARD_COHORT_ARGS = COHORT_ARGS
# 8b: a smoke arch with attention and Mamba layers, over 2 ranks against 1
SHARD_ARCH = "jamba-1.5-large-398b"
SHARD_ARCH_ARGS = ["--arch", SHARD_ARCH] + SMOKE_TRAIN_ARGS


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


def counted_run(torch, args, jit, run=None):
    """``launch.train``'s run of ``args`` (``run``: ``train.train_mlp``
    unless given, or ``train.train_arch``) on the driver ``jit`` picks,
    the launch counts set to 0 just before and read just after. Returns
    (result, state, history, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import train

    kernels.reset_launch_counts()
    result, state, hist = (run or train.train_mlp)(args, jit=jit)
    torch.cuda.synchronize()
    return result, state, hist, kernels.launch_counts()


def drive_path(torch, dev, flags, want, what, falling=True):
    """Run ``launch.train`` with ``flags`` on the card, by the graph driver
    (the trainer's default for its static batch) and by the loop driver
    (``jit=False``); check both runs' launch counts against ``want``, that
    the two runs agree bitwise (params, every per-round metric, the ledger's
    fields and head), the ledger, finite metrics, (``falling``) a falling
    global loss, and that neither the loop's rounds nor the replays make a
    host sync (``watched_rounds`` on those two runs, kept in
    ``result["host_syncs"]``). Returns (args, result, state, history,
    launches) of the graph driver's run."""
    from repro_torch import kernels
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}
    with watched_rounds(torch) as syncs:
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
    syncs = result["host_syncs"] = {key: syncs[key] for key
                                    in ("loop", "setup", "replays")}
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


@contextlib.contextmanager
def watched_rounds(torch):
    """Within the block, read the host syncs of each part of the round
    drivers' runs that the block makes through the entry points themselves
    (the buffers' set-up and the end-of-run transfer left out): ``loop``,
    each ``RoundRunner.step`` the loop driver calls; ``setup``, each
    ``CapturedRounds`` made (the graph driver's warm round and captures);
    ``replays``, each ``CapturedRounds.replay``. The design makes none in
    the rounds: the carry, the metrics, the mixing matrices and the noise
    (uploaded before the rounds) and every input of the race stay on the
    device. Yields ``{part: [warnings]}`` and the host seconds of each part
    under ``"seconds"`` (between two synchronizes)."""
    from repro_torch.core import rounds

    out = {"loop": [], "setup": [], "replays": [],
           "seconds": {"loop": 0.0, "setup": 0.0, "replays": 0.0}}
    step = rounds.RoundRunner.step
    init = rounds.CapturedRounds.__init__
    replay = rounds.CapturedRounds.replay
    capturing = []

    def watch(part, fn, *args):
        t0 = time.perf_counter()
        out[part] += host_syncs(torch, lambda: fn(*args))
        out["seconds"][part] += time.perf_counter() - t0

    def watched_step(self, *args):
        if capturing:   # the graph driver's warm round and captures
            return step(self, *args)
        return watch("loop", step, self, *args)

    def watched_init(self, *args):
        capturing.append(True)
        try:
            watch("setup", init, self, *args)
        finally:
            capturing.pop()

    rounds.RoundRunner.step = watched_step
    rounds.CapturedRounds.__init__ = watched_init
    rounds.CapturedRounds.replay = lambda self: watch("replays", replay,
                                                      self)
    try:
        yield out
    finally:
        rounds.RoundRunner.step = step
        rounds.CapturedRounds.__init__ = init
        rounds.CapturedRounds.replay = replay


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


def _flash_work(b, h, hkv, s, d, causal, window, prefix=0):
    """(bytes, flops, exps) the attention function needs: q, k, v read
    once and o written once; 4 D flops (QK^T and PV) and one exp per
    (row, key) pair the masks keep (under causal, the rows below
    ``prefix`` keep every key below it too)."""
    pairs = 0
    for row in range(s):
        lo = max(0, row - window + 1) if window > 0 else 0
        hi = (max(row + 1, min(prefix, s) if row < prefix else 0) if causal
              else s)
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
    prefix_err = 0.0
    for b, h, hkv, s, d, window, prefix, bf16 in FLASH_PREFIX_CASES:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        if bf16:
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        got = flash_ops.mha(q, k, v, causal=True, window=window,
                            prefix_len=prefix).float()
        want = flash_ref.mha_ref(q.float(), k.float(), v.float(),
                                 causal=True, window=window,
                                 prefix_len=prefix)
        err = (got - want).abs()
        atol, rtol = ((FLASH_BF16_ATOL, FLASH_BF16_RTOL) if bf16
                      else (FLASH_ATOL, FLASH_RTOL))
        if bf16:
            flash_bf16_err = max(flash_bf16_err, float(err.max()))
        else:
            prefix_err = max(prefix_err, float(err.max()))
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"flash_attention off tolerance at {(b, h, hkv, s, d)} with "
                f"window {window}, prefix {prefix}"
                f"{' (bf16)' if bf16 else ''}: max |diff| "
                f"{float(err.max()):.3g}")
        del q, k, v, got, want, err
    flash_err = max(flash_err, prefix_err)
    for b, h, hkv, s, d in FLASH_PREFIX_CAUSAL:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        base = flash_ops.mha(q, k, v, causal=True)
        for prefix in (0, 1):
            require(torch.equal(flash_ops.mha(q, k, v, causal=True,
                                              prefix_len=prefix), base),
                    f"flash_attention at {(b, h, hkv, s, d)}: prefix "
                    f"{prefix} is not bitwise the causal call")
        del q, k, v, base

    def flash_times(shape, tag, causal=True, prefix=0):
        """The flash kernel at ``shape``: its row (its time by the profiler
        and CUDA events, its plain version's, SDPA's in fp32 with the same
        mask: ``is_causal``, or the prefix mask as a boolean [S, S]; and,
        under a prefix, SDPA with no mask at all; its bound as 3xTF32, the
        kernel's), and for the summary line its kept (row, key) pairs and
        its bound as one fp32 pass outside the tensor cores."""
        b, h, hkv, s, d = shape
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        keep = (flash_ref.keep_mask(s, causal=True, window=0,
                                    prefix_len=prefix, device=dev)
                if prefix else None)

        def flash():
            return flash_ops.mha(q, k, v, causal=causal, prefix_len=prefix)

        def sdpa():   # timed only: the port never calls it
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, is_causal=causal and not prefix,
                enable_gqa=True)

        def sdpa_unmasked():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)

        require(float((sdpa().transpose(1, 2) - flash()).abs().max())
                < 1e-4, f"SDPA and the flash kernel disagree at {shape}")
        work = _flash_work(b, h, hkv, s, d, causal, 0, prefix)
        bound, by = _bound(*work, tf32_passes=FLASH_TF32_PASSES)
        label = f"flash_attention{tag}"
        times = dict(
            ms=timing.kernel_ms(flash, label, reps=10),
            call_ms=timing.time_ms(flash, reps=10, warmup=2),
            plain_ms=timing.kernel_ms(lambda: flash_ref.mha_ref(
                q, k, v, causal=causal, prefix_len=prefix),
                f"{label} plain", reps=3),
            library_ms=timing.kernel_ms(sdpa, f"{label} library (SDPA)",
                                        reps=10),
            bound_ms=bound, bound_by=by)
        if prefix:
            times["library_unmasked_ms"] = timing.kernel_ms(
                sdpa_unmasked, f"{label} library (SDPA, no mask)", reps=10)
        times["events_ms"] = timing.READINGS[label]["events_ms"]
        return times, {"kept_pairs": work[2], "bound_ms": bound,
                       "bound_fp32_ms": _bound(*work)[0]}

    # the row is timed at the MLA path's shape (4 launches a DeepSeek
    # prefill); the GQA, VLM and audio paths' shapes are kept beside it
    gqa, gqa_work = flash_times(FLASH_PATH, " (gqa path)")
    vlm, vlm_work = flash_times(FLASH_VLM_PATH, " (vlm path, prefix)",
                                prefix=FLASH_VLM_PREFIX)
    audio, audio_work = flash_times(FLASH_AUDIO_PATH,
                                    " (audio path, bidirectional)",
                                    causal=False)
    mla, mla_work = flash_times(FLASH_MLA_PATH, "")
    flash_work = {"mla path": mla_work, "gqa path": gqa_work,
                  "vlm path": vlm_work, "audio path": audio_work}
    report["flash_attention"] = dict(
        max_abs_err=flash_err, max_abs_err_bf16=flash_bf16_err,
        max_abs_err_prefix=prefix_err, **mla,
        at_gqa_path={"shape": FLASH_PATH, **gqa},
        at_vlm_path={"shape": FLASH_VLM_PATH, "prefix": FLASH_VLM_PREFIX,
                     **vlm},
        at_audio_path={"shape": FLASH_AUDIO_PATH, "causal": False, **audio})

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
    print(f"phase 1b ok: flash_attention at {len(FLASH_CASES)} cases, "
          f"{len(FLASH_MISALIGNED)} misaligned fp32 views and "
          f"{len(FLASH_PREFIX_CASES)} prefix-LM cases (largest fp32 "
          f"deviation {prefix_err:.3g}; prefix 0, the default, and 1 "
          f"bitwise the causal call at {len(FLASH_PREFIX_CAUSAL)} "
          f"shapes), largest "
          f"deviation {flash_err:.3g} in fp32 (rtol {FLASH_RTOL}, "
          f"atol {FLASH_ATOL}) and {flash_bf16_err:.3g} in bf16 (rtol "
          f"{FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}); its kept (row, "
          f"key) pairs and its bound as {FLASH_TF32_PASSES} TF32 passes "
          f"(the kernel's, bound_ms) and as one fp32 pass outside the "
          f"tensor cores (bound_fp32_ms) at the paths' shapes "
          + json.dumps(flash_work) + f"; ssm_scan at "
          f"{len(ssm_cases)} cases ({len(SSM_MISALIGNED)} of offset "
          f"views), largest deviation {ssm_err:.3g}, "
          f"{ssm_ratio:.3g} of atol {SSM_ATOL} + "
          f"rtol {SSM_RTOL} |want|; times " + json.dumps(
              {n: {key: row[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
               for n, row in (("flash_attention", report["flash_attention"]),
                              ("flash_attention (gqa path)", gqa),
                              ("flash_attention (vlm path)", vlm),
                              ("flash_attention (audio path)", audio),
                              ("ssm_scan", report["ssm_scan"]))}),
          flush=True)
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
    require(math.isfinite(result["peak_mem_gb"]),
            f"peak memory not read on the serve path: {result}")
    print(f"phase {label} ok: " + json.dumps(
        {key: result[key] for key in
         ("arch", "batch", "prompt_len", "generated_tokens", "prefill_s",
          "decode_s", "tokens_per_s", "peak_mem_gb", "prefill_dropped_share",
          "launches")}),
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
        h, _, _ = transformer.forward(
            params, cfg, transformer._embed_inputs(params, cfg,
                                                   {"tokens": toks})[0])
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
        prefill_breakdown(torch, params, cfg,
                          {"tokens": tokens[:, :AGREE_PREFILL]}, profile_dir,
                          "jamba")
    print("phase 4b ok", flush=True)


def layer_card_vs_cpu(torch, what, fn, params, x):
    """``fn(params, x)`` on the card and on a CPU copy of both; require
    the card within LAYER_RTOL / LAYER_ATOL of the CPU and return the
    worst |diff| / (atol + rtol |cpu|)."""
    from repro_torch.tree import tree_map

    got = fn(params, x).cpu()
    want = fn(tree_map(lambda t: t.cpu(), params), x.cpu())
    ratio = float(((got - want).abs()
                   / (LAYER_ATOL + LAYER_RTOL * want.abs())).max())
    require(ratio <= 1, f"{what}: card vs cpu at {ratio:.3g} of atol "
                        f"{LAYER_ATOL} + rtol {LAYER_RTOL} |cpu|")
    return ratio


def phase_mla_agreement(torch, dev, profile_dir):
    """Phase 4d: on the DeepSeek serve path's full-width params (the same
    seed), (i) with the capacity out of the way (UNCAPPED_FACTOR, no
    choice dropped, which the phase asserts), prefill of MLA_AGREE_PREFILL
    tokens and AGREE_STEPS teacher-forced decode steps (MLA absorbed, MoE
    at T = B) against one forward over all of them (MLA materialized on
    the flash kernel, MoE at T = B S), then the decode loop's host syncs;
    (ii) the first MoE layer and the first MLA layer on LAYER_TOKENS
    tokens, card against CPU, and the routing of the card's router logits
    by ``moe.route`` on both devices, which must be equal. With
    ``profile_dir``, profile one prefill as served (B 4 x 2048)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import attention, moe, registry, transformer

    args = serve.build_parser().parse_args(MLA_SERVE_ARGS
                                           + ["--device", str(dev)])
    cfg = serve.config_of(args)
    params = registry.init_model(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    uncapped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=UNCAPPED_FACTOR))
    n = MLA_AGREE_PREFILL + AGREE_STEPS
    tokens = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
        ShapeConfig("agree", n, args.batch, "prefill"))["tokens"]
    drops = []
    h, _, _ = transformer.forward(
        params, uncapped, transformer._embed_inputs(
            params, uncapped, {"tokens": tokens})[0], moe_drops=drops)
    want = transformer._lm_head(params, uncapped,
                                h[:, MLA_AGREE_PREFILL - 1:])
    del h
    logits, state = transformer.prefill(
        params, uncapped, {"tokens": tokens[:, :MLA_AGREE_PREFILL]},
        max_len=n + SYNC_CHECK_STEPS, moe_drops=drops)
    dropped = sum(int(c) for _, c in drops)
    n_moe = sum(transformer._uses_moe(cfg, i) for i in range(cfg.n_layers))
    require(len(drops) == 2 * n_moe and dropped == 0,
            f"{dropped} choices dropped in {len(drops)} uncapped MoE calls")
    got = [logits]
    for t in range(MLA_AGREE_PREFILL, n):
        logits, state = transformer.decode_step(params, uncapped, state,
                                                tokens[:, t], t)
        got.append(logits)
    err = float((torch.stack(got, 1) - want).abs().max())
    scale = float(want.abs().max())
    syncs = host_syncs(torch, lambda: serve.decode_loop(
        params, uncapped, state, torch.argmax(logits, -1), n,
        SYNC_CHECK_STEPS))
    del state, got, want

    gen = torch.Generator(device=dev).manual_seed(4322)
    x = torch.randn((1, LAYER_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    moe_p = transformer._period(params["period"], 0)["j0"]["moe"]
    logits_card = x.reshape(-1, cfg.d_model) @ moe_p["router"]
    r_card = moe.route(logits_card, cfg)
    r_cpu = moe.route(logits_card.cpu(), cfg)
    require(r_card.capacity == r_cpu.capacity
            and all(torch.equal(getattr(r_card, f).cpu(), getattr(r_cpu, f))
                    for f in ("gate_idx", "slots", "keeps")),
            "moe.route on the card and on the CPU disagree on the card's "
            "router logits")
    positions = torch.arange(LAYER_TOKENS, dtype=torch.int32,
                             device=dev)[None]
    mask = {"causal": True, "prefix_len": 0, "window": 0}
    moe_ratio = layer_card_vs_cpu(
        torch, "MoE layer", lambda p, v: moe.moe_apply(p, cfg, v)[0],
        moe_p, x)
    mla_ratio = layer_card_vs_cpu(
        torch, "MLA layer", lambda p, v: attention.mla_forward(
            p, cfg, v, positions.to(v.device), mask)[0],
        params["prefix"][0]["mixer"], x)
    print(f"phase 4d: uncapped (capacity factor {UNCAPPED_FACTOR}), "
          f"prefill of {MLA_AGREE_PREFILL} + {AGREE_STEPS} decode steps vs "
          f"forward over {n} tokens: max |logit diff| {err:.3g} (max "
          f"|logit| {scale:.3g}, limit {AGREE_LIMIT}), 0 of "
          f"{sum(a for a, _ in drops)} choices dropped; host syncs in "
          f"{SYNC_CHECK_STEPS} decode steps: {len(syncs)}; on "
          f"{LAYER_TOKENS} tokens, card vs cpu at {moe_ratio:.3g} (MoE "
          f"layer, capacity {r_card.capacity}, "
          f"{int((~r_cpu.keeps).sum())} of {r_cpu.keeps.numel()} choices "
          f"dropped) and {mla_ratio:.3g} (MLA layer) of atol {LAYER_ATOL} "
          f"+ rtol {LAYER_RTOL} |cpu|; routing equal", flush=True)
    require(err <= AGREE_LIMIT,
            f"DeepSeek serve path disagrees with the forward: {err:.3g} > "
            f"{AGREE_LIMIT}")
    require(not syncs, f"{len(syncs)} host syncs in the decode loop: "
                       f"{syncs[:3]}")
    if profile_dir:
        tokens = registry.make_prefill_batch(
            torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
            ShapeConfig("serve", args.prompt_len, args.batch,
                        "prefill"))["tokens"]
        prefill_breakdown(torch, params, cfg, {"tokens": tokens},
                          profile_dir, "deepseek")
    print("phase 4d ok", flush=True)


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _sync_s(torch, fn):
    """(fn's result, its host-clock seconds between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _decode_agreement(torch, params, cfg, batch, n_prefill, n, first_pos):
    """Prefill of ``batch`` cut to its first ``n_prefill`` positions, then
    teacher-forced decode steps up to ``n``, against one forward over all
    ``n`` positions: max |logit diff| and the largest |logit|. ``first_pos``
    is the position of the first token of ``batch["tokens"]`` (the
    patches come first in a VLM's)."""
    from repro_torch.models import transformer

    toks = batch["tokens"]
    h, _, _ = transformer.forward(
        params, cfg, transformer._embed_inputs(params, cfg, batch)[0])
    want = transformer._lm_head(params, cfg, h[:, n_prefill - 1:n])
    del h
    cut = {**batch, "tokens": toks[:, :n_prefill - first_pos]}
    logits, state = transformer.prefill(params, cfg, cut,
                                        max_len=n + 2 * SYNC_CHECK_STEPS)
    got = [logits]
    for t in range(n_prefill, n):
        logits, state = transformer.decode_step(params, cfg, state,
                                                toks[:, t - first_pos], t)
        got.append(logits)
    err = float((torch.stack(got, 1) - want).abs().max())
    return err, float(want.abs().max()), state, logits


def phase_xlstm(torch, dev, profile_dir):
    """Phase 4e: xlstm-125m ONE_H100 (the published config) served as phase
    4 serves Jamba: no kernel launch (flash 0, scan 0: xLSTM runs none);
    then on the same params prefill of XLSTM_AGREE_PREFILL tokens and
    AGREE_STEPS decode steps against one forward, the decode loop's host
    syncs, one mLSTM and one sLSTM layer card against CPU on LAYER_TOKENS
    tokens and a warm prefill's seconds. With ``profile_dir``, profile 4
    decode steps and one prefill (whose host time in each block kind's
    mixers gives the sLSTM time loops' share)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer, xlstm

    result, launches = phase_serve(torch, dev, XLSTM_SERVE_ARGS,
                                   XLSTM_SERVE_LAUNCHES, "4e (serve)")
    args = serve.build_parser().parse_args(XLSTM_SERVE_ARGS
                                           + ["--device", str(dev)])
    cfg = serve.config_of(args)
    params = registry.init_model(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    n = XLSTM_AGREE_PREFILL + AGREE_STEPS
    batch = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
        ShapeConfig("agree", n, args.batch, "prefill"))
    err, scale, state, logits = _decode_agreement(
        torch, params, cfg, batch, XLSTM_AGREE_PREFILL, n, 0)
    syncs = host_syncs(torch, lambda: serve.decode_loop(
        params, cfg, state, torch.argmax(logits, -1), n, SYNC_CHECK_STEPS))
    if profile_dir:
        profile_breakdown(torch, lambda: serve.decode_loop(
            params, cfg, state, torch.argmax(logits, -1),
            n + SYNC_CHECK_STEPS, SYNC_CHECK_STEPS), profile_dir,
            f"decode_xlstm_{SYNC_CHECK_STEPS}_steps")
    del state, logits
    served = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
        ShapeConfig("serve", args.prompt_len, args.batch, "prefill"))
    _, prefill_s = _sync_s(torch, lambda: transformer.prefill(
        params, cfg, served))

    gen = torch.Generator(device=dev).manual_seed(4323)
    x = torch.randn((1, LAYER_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    blocks = transformer._period(params["period"], 0)
    kinds = {kind: f"j{j}" for j, kind in enumerate(cfg.pattern)}
    ratios = {kind: layer_card_vs_cpu(
        torch, f"{kind} layer", lambda p, v, f=fwd: f(p, cfg, v)[0],
        blocks[kinds[kind]]["mixer"], x)
        for kind, fwd in (("mlstm", xlstm.mlstm_forward),
                          ("slstm", xlstm.slstm_forward))}
    print(f"phase 4e: {sum(t.numel() for t in _leaves(params))} "
          f"parameters; prefill of {XLSTM_AGREE_PREFILL} + {AGREE_STEPS} "
          f"decode steps vs forward over {n} tokens: max |logit diff| "
          f"{err:.3g} (max |logit| {scale:.3g}, limit {AGREE_LIMIT}); host "
          f"syncs in {SYNC_CHECK_STEPS} decode steps: {len(syncs)}; on "
          f"{LAYER_TOKENS} tokens, card vs cpu at {ratios['mlstm']:.3g} "
          f"(mLSTM layer, chunkwise) and {ratios['slstm']:.3g} (sLSTM "
          f"layer) of atol {LAYER_ATOL} + rtol {LAYER_RTOL} |cpu|; a warm "
          f"prefill at B {args.batch} x {args.prompt_len} took "
          f"{prefill_s:.4g} s (the served one, the first: "
          f"{result['prefill_s']:.4g} s)", flush=True)
    require(err <= AGREE_LIMIT, f"xLSTM serve path disagrees with the "
                                f"forward: {err:.3g} > {AGREE_LIMIT}")
    require(not syncs, f"{len(syncs)} host syncs in the decode loop: "
                       f"{syncs[:3]}")
    if profile_dir:
        prefill_breakdown(torch, params, cfg, registry.make_prefill_batch(
            torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
            ShapeConfig("serve", args.prompt_len, args.batch, "prefill")),
            profile_dir, "xlstm")
    print("phase 4e ok", flush=True)
    return launches


def phase_vlm(torch, dev, profile_dir):
    """Phase 4f: paligemma-3b ONE_H100 (the published config) served:
    flash_attention 18 times a prefill (prefix 256); then on the same
    params prefill of the 256 patches and 1792 text tokens and AGREE_STEPS
    decode steps against one forward, the decode loop's host syncs, and
    one attention layer under the prefix-LM mask card against CPU on
    LAYER_TOKENS + 44 tokens (the prefix square and a causal tail). With
    ``profile_dir``, profile one prefill."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import attention, registry, transformer

    result, launches = phase_serve(torch, dev, VLM_SERVE_ARGS,
                                   VLM_SERVE_LAUNCHES, "4f (serve)")
    args = serve.build_parser().parse_args(VLM_SERVE_ARGS
                                           + ["--device", str(dev)])
    cfg = serve.config_of(args)
    params = registry.init_model(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    n = args.prompt_len + AGREE_STEPS
    p = cfg.vlm_prefix_len
    batch = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
        ShapeConfig("agree", n, args.batch, "prefill"))
    err, scale, state, logits = _decode_agreement(
        torch, params, cfg, batch, args.prompt_len, n, p)
    syncs = host_syncs(torch, lambda: serve.decode_loop(
        params, cfg, state, torch.argmax(logits, -1), n, SYNC_CHECK_STEPS))
    if profile_dir:
        profile_breakdown(torch, lambda: serve.decode_loop(
            params, cfg, state, torch.argmax(logits, -1),
            n + SYNC_CHECK_STEPS, SYNC_CHECK_STEPS), profile_dir,
            f"decode_paligemma_{SYNC_CHECK_STEPS}_steps")
    del state, logits

    s = LAYER_TOKENS + 44
    x = torch.randn((1, s, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(4324),
                    device=dev)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    mask = {"causal": True, "prefix_len": p, "window": 0}
    ratio = layer_card_vs_cpu(
        torch, "attention layer (prefix-LM)",
        lambda prm, v: attention.gqa_forward(
            prm, cfg, v, positions.to(v.device), mask)[0],
        transformer._period(params["period"], 0)["j0"]["mixer"], x)
    print(f"phase 4f: {sum(t.numel() for t in _leaves(params))} "
          f"parameters; prefill of {p} patches + {args.prompt_len - p} "
          f"tokens and {AGREE_STEPS} decode steps vs forward over {n} "
          f"positions: max |logit diff| {err:.3g} (max |logit| "
          f"{scale:.3g}, limit {AGREE_LIMIT}); host syncs in "
          f"{SYNC_CHECK_STEPS} decode steps: {len(syncs)}; the attention "
          f"layer under the prefix-LM mask on {s} positions, card vs cpu "
          f"at {ratio:.3g} of atol {LAYER_ATOL} + rtol {LAYER_RTOL} |cpu|",
          flush=True)
    require(err <= AGREE_LIMIT, f"PaliGemma serve path disagrees with the "
                                f"forward: {err:.3g} > {AGREE_LIMIT}")
    require(not syncs, f"{len(syncs)} host syncs in the decode loop: "
                       f"{syncs[:3]}")
    if profile_dir:
        prefill_breakdown(torch, params, cfg, registry.make_prefill_batch(
            torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
            ShapeConfig("serve", args.prompt_len, args.batch, "prefill")),
            profile_dir, "paligemma")
    print("phase 4f ok", flush=True)
    return launches


def phase_audio(torch, dev, profile_dir):
    """Phase 4g: hubert-xlarge ONE_H100 (the published config, encoder
    only): with the launch counts set to 0 just before, the encoder's
    forward over AUDIO_BATCH x AUDIO_FRAMES frames (AUDIO_MASK_SHARE of them
    replaced by the mask embedding) and the codebook head's logits at every
    frame, what the reference's masked prediction computes before its
    loss: flash_attention 48 times (bidirectional, D 80), finite logits;
    its seconds and peak memory; then one attention layer card against
    CPU on LAYER_TOKENS frames. With ``profile_dir``, profile one forward
    (its device time by class)."""
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig, get_one_h100_arch
    from repro_torch.models import attention, registry, transformer

    cfg = get_one_h100_arch(AUDIO_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params = registry.init_model(torch.Generator(device=dev).manual_seed(0),
                                 cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = registry.make_prefill_batch(
        gen, cfg, ShapeConfig("encode", AUDIO_FRAMES, AUDIO_BATCH, "prefill"))
    batch["mask_positions"] = (torch.rand(
        (AUDIO_BATCH, AUDIO_FRAMES), generator=gen, device=dev)
        < AUDIO_MASK_SHARE).to(torch.int32)

    def encode():
        h, _, _ = transformer.forward(params, cfg, transformer._embed_inputs(
            params, cfg, batch)[0])
        return transformer._lm_head(params, cfg, h)

    kernels.reset_launch_counts()
    logits, encode_s = _sync_s(torch, encode)
    launches = kernels.launch_counts()
    want = {**{name: 0 for name in kernels.WRAPPERS}, **AUDIO_LAUNCHES}
    require(launches == want, f"launch counts {launches} on the audio "
                              f"encoder path, expected {want}")
    require(tuple(logits.shape) == (AUDIO_BATCH, AUDIO_FRAMES, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"audio encoder logits {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del logits
    _, again_s = _sync_s(torch, encode)

    x = torch.randn((1, LAYER_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    positions = torch.arange(LAYER_TOKENS, dtype=torch.int32,
                             device=dev)[None]
    mask = {"causal": False, "prefix_len": 0, "window": 0}
    ratio = layer_card_vs_cpu(
        torch, "attention layer (bidirectional)",
        lambda prm, v: attention.gqa_forward(
            prm, cfg, v, positions.to(v.device), mask)[0],
        transformer._period(params["period"], 0)["j0"]["mixer"], x)
    print("phase 4g ok: " + json.dumps(
        {"arch": cfg.name, "batch": AUDIO_BATCH, "frames": AUDIO_FRAMES,
         "params": sum(t.numel() for t in _leaves(params)),
         "encode_s": encode_s, "encode_again_s": again_s,
         "peak_mem_gb": peak_gb, "launches": launches,
         "layer_card_vs_cpu": ratio}), flush=True)
    if profile_dir:
        prefill_breakdown(torch, params, cfg, batch, profile_dir, "hubert")
    return launches


def _grad_ratio(torch, got, want, rtol, atol):
    """Largest |got - want| / (rtol |want| + atol max|want|) of one
    gradient tensor."""
    got, want = got.double(), want.double()
    tol = rtol * want.abs() + atol * float(want.abs().max().clamp_min(1e-30))
    return float(((got - want).abs() / tol).max())


def _flash_grad_inputs(torch, gen, case):
    b, h, hkv, s, d = case[:5]
    q = torch.randn((b, s, h, d), generator=gen, device=gen.device)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=gen.device)
            for _ in range(2))
    do = torch.randn((b, s, h, d), generator=gen, device=gen.device)
    return [x.requires_grad_() for x in (q, k, v)], do


def _ssm_grad_inputs(torch, gen, case):
    """u, dt, B, C, a, d_skip (requiring grad) and the cotangents dy, dh
    at (B, T, d_in, ds, dt scale); a as Jamba's -exp(a_log), a_log =
    log(1..ds), spread."""
    import torch.nn.functional as F

    bsz, t, d_in, ds, scale = case
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u, bm, cm = randn(bsz, t, d_in), randn(bsz, t, ds), randn(bsz, t, ds)
    dt = scale * F.softplus(randn(bsz, t, d_in) - 2)
    a = -(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)
          * torch.exp(0.3 * randn(d_in, ds)))
    d_skip = randn(d_in)
    xs = [x.requires_grad_() for x in (u, dt, bm, cm, a, d_skip)]
    return xs, randn(bsz, t, d_in), randn(bsz, d_in, ds)


def phase_train_grads(torch, dev, report):
    """Phase 7a: each backward kernel against autograd through its plain
    twin on the same CUDA inputs with a random cotangent. ``mha`` under
    grad (``_FlashFn``: the forward with lse, then the backward kernel) at
    FLASH_GRAD_CASES against ``ref.mha_ref``'s autograd, and ``ssm_scan``
    under grad (``_ScanFn``: the forward with its chunk states, then the
    backward kernel) at SSM_GRAD_CASES against ``ref.ssm_scan_ref``'s,
    each gradient within its tolerance; one launch of each kernel a call;
    two calls bitwise equal; the forward's outputs under grad bitwise those
    of the serving launch (lse and chunk states off). Fills the backward
    rows' max_abs_err in ``report``."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    gen = torch.Generator(device=dev).manual_seed(9753)
    worst = {"flash": {}, "scan": {}}
    errs = {"flash_attention_bwd": 0.0, "ssm_scan_bwd": 0.0}

    def run_twice(fwd, xs, cot, name, what):
        """fwd(*xs) under grad, its gradients twice (the launch counts and
        the bits checked); returns (outputs, grads)."""
        grads = []
        for _ in range(2):
            before = kernels.launch_counts()
            outs = fwd(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads.append(torch.autograd.grad(outs, xs, cot))
            after = kernels.launch_counts()
            require(after[name] - before[name] == 1
                    and after[name + "_bwd"] - before[name + "_bwd"] == 1,
                    f"{what}: launches {before} -> {after}, expected one "
                    f"{name} and one {name}_bwd")
        require(all(torch.equal(a, b) for a, b in zip(*grads)),
                f"{what}: two backward calls differ")
        return [o.detach() for o in outs], grads[0]

    for case in FLASH_GRAD_CASES:
        causal, window, prefix = case[5:]
        mask = dict(causal=causal, window=window, prefix_len=prefix)
        (q, k, v), do = _flash_grad_inputs(torch, gen, case)
        outs, got = run_twice(lambda q, k, v: flash_ops.mha(q, k, v, **mask),
                              [q, k, v], (do,), "flash_attention",
                              f"flash at {case}")
        with torch.no_grad():
            serve = flash_ops.mha(q, k, v, **mask)
        require(torch.equal(outs[0], serve),
                f"flash at {case}: the forward with lse is not bitwise "
                "the serving launch")
        want = torch.autograd.grad(flash_ref.mha_ref(q, k, v, **mask),
                                   [q, k, v], do)
        ratios = [_grad_ratio(torch, g, w, FLASH_GRAD_RTOL, FLASH_GRAD_ATOL)
                  for g, w in zip(got, want)]
        worst["flash"][str(case)] = max(ratios)
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"],
            *(float((g - w).abs().max()) for g, w in zip(got, want)))
        require(max(ratios) <= 1,
                f"flash backward off tolerance at {case}: dq, dk, dv at "
                f"{ratios} of rtol {FLASH_GRAD_RTOL} |want| + atol "
                f"{FLASH_GRAD_ATOL} max|want|")
        del q, k, v, do, outs, got, want, serve
    for case in SSM_GRAD_CASES:
        xs, dy, dh = _ssm_grad_inputs(torch, gen, case)
        if case[4] > 1:
            require(bool((torch.exp(xs[1][..., None] * xs[4]) == 0).any()),
                    f"scan case {case}: exp(dt a) never underflows")
        outs, got = run_twice(ssm_ops.ssm_scan, xs, (dy, dh), "ssm_scan",
                              f"scan at {case}")
        with torch.no_grad():
            serve = ssm_ops.ssm_scan(*xs)
        require(all(torch.equal(a, b) for a, b in zip(outs, serve)),
                f"scan at {case}: the forward with chunk states is not "
                "bitwise the serving launch")
        want = torch.autograd.grad(ssm_ref.ssm_scan_ref(*xs), xs, (dy, dh))
        ratios = [_grad_ratio(torch, g, w, SSM_GRAD_RTOL, SSM_GRAD_ATOL)
                  for g, w in zip(got, want)]
        worst["scan"][str(case)] = max(ratios)
        errs["ssm_scan_bwd"] = max(
            errs["ssm_scan_bwd"],
            *(float((g - w).abs().max()) for g, w in zip(got, want)))
        require(max(ratios) <= 1,
                f"scan backward off tolerance at {case}: du, ddt, dB, dC, "
                f"da, dd_skip at {ratios} of rtol {SSM_GRAD_RTOL} |want| + "
                f"atol {SSM_GRAD_ATOL} max|want|")
        del xs, dy, dh, outs, got, want, serve
    _free(torch)
    for name, err in errs.items():
        report[name] = {"max_abs_err": err}
    print("phase 7a ok: backward kernels against autograd through the "
          "plain twins, two calls bitwise equal, the forward bitwise the "
          "serving launch; worst share of the tolerance by case "
          + json.dumps(worst), flush=True)


def launch_split(torch, fn, reps=10):
    """Each kernel that ``fn`` launches, by name (its C++ name up to the
    template arguments): [device ms a launch, launches recorded], the mean
    over one profile of ``reps`` calls. The profiler drops activities, so
    a kernel's mean is taken over the launches it recorded."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"::(\w+)[<(]", e.name)
            name = m.group(1) if m else e.name[:40]
            ms, n = split.get(name, (0.0, 0))
            split[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {name: [ms / n, n] for name, (ms, n) in split.items()}


def phase_bwd_times(torch, dev, report):
    """Phase 7b (backward kernels): the flash backward at phi4-mini's
    training shape and the scan backward at Jamba's layer shape, each call
    alone (its wrapper on the saved tensors, by the profiler and CUDA
    events), beside the plain twin's autograd backward and, for flash,
    SDPA's fp32 backward (and its forward + backward), timed only; their
    bounds. Adds the rows' times to ``report``."""
    import torch.nn.functional as F

    from repro_torch.benchmarks import timing
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    gen = torch.Generator(device=dev).manual_seed(2468)
    b, h, hkv, s, d = FLASH_TRAIN_PATH
    (q, k, v), do = _flash_grad_inputs(torch, gen, FLASH_TRAIN_PATH)
    mask = dict(seq_axis=1, head_axis=2, causal=True, window=0,
                scale=1.0 / math.sqrt(d), prefix_len=0)
    with torch.no_grad():
        o, lse = flash_ops._forward_lse(q, k, v, **mask)
    plain = flash_ref.mha_ref(q, k, v, causal=True)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():   # timed only: the port never calls it
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    pairs = _flash_work(b, h, hkv, s, d, True, 0)[2]
    # q, k, v, o, dO and lse read; dq, dk, dv written; 10 D flops a kept
    # pair (S, dP, dV, dK, dQ) as three TF32 passes, the card's fastest
    # fp32-faithful products (the kernel's arithmetic, and row 6's), one
    # exp a pair; and, for the phase's line, the same flops as one pass of
    # fp32 FMAs outside the tensor cores
    bwd_work = (4 * (4 * b * s * h * d + 2 * b * s * hkv * d + b * h * s
                     + b * s * h * d + 2 * b * s * hkv * d),
                10 * d * pairs, pairs)
    bound, by = _bound(*bwd_work, tf32_passes=FLASH_TF32_PASSES)
    bound_fp32_ms = _bound(*bwd_work)[0]
    report["flash_attention_bwd"].update(
        ms=timing.kernel_ms(lambda: flash_ops.flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), o, lse, do, **mask),
            "flash_attention_bwd", reps=10,
            # D, dK/dV, the group sum under GQA, dQ
            ops=flash_ops.launches_a_call(h, hkv)),
        plain_ms=timing.kernel_ms(lambda: torch.autograd.grad(
            plain, (q, k, v), do, retain_graph=True),
            "flash_attention_bwd plain (autograd of mha_ref)", reps=5),
        library_ms=timing.kernel_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True),
            "flash_attention_bwd library (SDPA backward, fp32)", reps=10),
        library_fwd_bwd_ms=timing.kernel_ms(
            sdpa_fwd_bwd, "flash_attention_bwd library (SDPA forward + "
            "backward, fp32)", reps=10),
        bound_ms=bound, bound_by=by, kept_pairs=pairs,
        shape=FLASH_TRAIN_PATH,
        launch_split_ms=launch_split(torch, lambda: (
            flash_ops.flash_attention_bwd(q.detach(), k.detach(),
                                          v.detach(), o, lse, do, **mask))))
    report["flash_attention_bwd"]["events_ms"] = \
        timing.READINGS["flash_attention_bwd"]["events_ms"]
    del q, k, v, do, o, lse, plain, qt, kt, vt, lib_out, dot
    _free(torch)

    xs, dy, dh = _ssm_grad_inputs(torch, gen, SSM_TRAIN_PATH + (1.0,))
    f32 = [x.detach() for x in xs]
    with torch.no_grad():
        _, _, h_chunks = ssm_ops._launch(*f32, chunks=True)
    plain = ssm_ref.ssm_scan_ref(*xs)
    bsz, t, d_in, ds = SSM_TRAIN_PATH
    n = bsz * t * d_in
    # the gradient's own inputs read once and outputs written once: u, dt,
    # dy read, du, ddt written; B, C read, dB, dC written; a, d_skip read
    # and their grads written; dh read (not the chunk states, which are
    # the algorithm's); one exp(dt a) a (b, t, channel, state) and twice
    # the forward's flops (_ssm_work)
    scan_bytes = 4 * (5 * n + 4 * bsz * t * ds + 4 * d_in * ds + 2 * d_in
                      + bsz * d_in * ds)
    fwd_flops = _ssm_work(bsz, t, d_in, ds)[1]
    bound, by = _bound(scan_bytes, 2 * fwd_flops, n * ds)
    report["ssm_scan_bwd"].update(
        ms=timing.kernel_ms(lambda: ssm_ops.ssm_scan_bwd(
            *f32, h_chunks, dy, dh), "ssm_scan_bwd", reps=10,
            ops=2),   # the sweep, then one launch of the four sums
        plain_ms=timing.kernel_ms(lambda: torch.autograd.grad(
            plain, xs, (dy, dh), retain_graph=True),
            "ssm_scan_bwd plain (autograd of ssm_scan_ref)", reps=1),
        library_ms=None, bound_ms=bound, bound_by=by, shape=SSM_TRAIN_PATH,
        launch_split_ms=launch_split(torch, lambda: ssm_ops.ssm_scan_bwd(
            *f32, h_chunks, dy, dh)))
    report["ssm_scan_bwd"]["events_ms"] = \
        timing.READINGS["ssm_scan_bwd"]["events_ms"]
    del xs, f32, dy, dh, h_chunks, plain
    _free(torch)
    flash = report["flash_attention_bwd"]
    print("phase 7b ok (backward kernels): " + json.dumps(
        {name: {key: report[name][key] for key in
                ("shape", "ms", "events_ms", "plain_ms", "library_ms",
                 "bound_ms", "bound_by", "launch_split_ms")}
         | {"over_bound": report[name]["ms"] / report[name]["bound_ms"],
            "events_over_bound": (report[name]["events_ms"]
                                  / report[name]["bound_ms"])}
         for name in ("flash_attention_bwd", "ssm_scan_bwd")}
        | {"sdpa_fwd_bwd_ms": flash["library_fwd_bwd_ms"],
           "flash_attention_bwd_over_sdpa_bwd":
               flash["ms"] / flash["library_ms"],
           "flash_attention_bwd_events_over_sdpa_bwd":
               flash["events_ms"] / timing.READINGS[
                   "flash_attention_bwd library (SDPA backward, fp32)"][
                   "events_ms"],
           "flash_attention_bwd_bound_fp32_ms": bound_fp32_ms}),
        flush=True)


def train_leaf_widths(torch, dev, cfg):
    """{leaf path: width} of the params of ``cfg``, as the round engine
    flattens them (``tree.flatten``), drawn on the card."""
    from repro_torch import tree
    from repro_torch.models import registry

    params = tree.flatten(registry.init_model(
        torch.Generator(device=dev).manual_seed(0), cfg))
    widths = {k: v.numel() for k, v in params.items()}
    del params
    _free(torch)
    return widths


def phase_train_kernels(torch, dev, report):
    """Phase 7b: the FL kernels at the shapes the LM training path gives
    them: ``fedavg_flat`` (uniform and weighted, with and without noise)
    and ``digest_div_flat`` within their tolerances at C = TRAIN_CLIENTS
    on every leaf of xLSTM-125M as phase 7c cuts it (``xlstm_one_period``;
    up to the 50 304 x 768 embedding, 38.6 M
    floats a row), the mine kernel in seal mode bitwise at C =
    TRAIN_CLIENTS and 256 attempts at two offsets; then the times of one
    round's calls (every leaf) and of one call at the embedding, with
    their bounds, and the same two kernels held and timed at phi4-mini's
    embedding (PHI4_EMBED floats a client), added to ``report``'s rows
    under ``at_lm_train``."""
    from repro_torch.benchmarks import timing
    from repro_torch.core import mining
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.fedavg import ref as fedavg_ref
    from repro_torch.kernels.pow_hash import ops as pow_ops
    from repro_torch.kernels.pow_hash import ref as pow_ref

    c, attempts = TRAIN_CLIENTS, 256
    widths = train_leaf_widths(torch, dev, xlstm_one_period())
    gen = torch.Generator(device=dev).manual_seed(8643)
    uniform = torch.full((c,), 1.0 / c, device=dev)
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    fed_err = dig_err = 0.0
    for name, n in widths.items():
        x = torch.randn((c, n), generator=gen, device=dev) + 0.25
        noise = 0.1 * torch.randn((c, n), generator=gen, device=dev)
        for weights in (uniform, (w / w.sum()).contiguous()):
            for nz in (None, noise):
                got = fedavg_ops.fedavg_flat(x, weights, nz)
                want = fedavg_ref.fedavg_flat_ref(x, weights, nz)
                err = (got - want).abs()
                fed_err = max(fed_err, float(err.max()))
                require(bool((err <= FLOAT_ATOL + FLOAT_RTOL
                              * want.abs()).all()),
                        f"fedavg_flat off tolerance at C={c} on the "
                        f"xLSTM leaf {name} ({n} floats)")
                del got, want, err
        dig_err = max(dig_err, check_digest(torch, x, f"C={c} xLSTM leaf "
                                                      f"{name}"))
        del x, noise
    for off in (7 << 20, (1 << 32) - 99):
        prev, digest, offset = (
            torch.full((), val & mining.MASK, dtype=torch.int64, device=dev)
            for val in (0x1357BDF, 0x2468ACE ^ off, off))
        got = pow_ops.mine_seal(prev, digest, c, attempts,
                                nonce_offset=offset, difficulty_bits=2)
        want = pow_ref.mine_seal_ref(prev, digest, offset, c, attempts, 2)
        require(same_seal(torch, got, want),
                f"mine_seal not bitwise equal at C={c}, {attempts} "
                f"attempts, offset {off}")
    _free(torch)

    widest = max(widths, key=widths.get)
    big = widths[widest]
    elems = sum(widths.values())
    xs = [torch.randn((c, n), generator=gen, device=dev)
          for n in widths.values()]
    x_big = xs[list(widths).index(widest)]
    timed = {"fedavg_flat": {}, "digest_div_flat": {}, "pow_race": {}}
    for tag, fed_fn, dig_fn, n in (
            ("all_leaves", lambda: [fedavg_ops.fedavg_flat(x, uniform)
                                    for x in xs],
             lambda: [fedavg_ops.digest_div_flat(x) for x in xs], elems),
            (f"leaf_{big}", lambda: fedavg_ops.fedavg_flat(x_big, uniform),
             lambda: fedavg_ops.digest_div_flat(x_big), big)):
        timed["fedavg_flat"][tag] = dict(
            ms=timing.kernel_ms(fed_fn, f"fedavg_flat C={c} {tag}"),
            bound_ms=1e3 * max((8 * c * n + 16 * c) / PEAK_BYTES_S,
                               2 * c * n / PEAK_ALU_OPS_S))
        timed["digest_div_flat"][tag] = dict(
            ms=timing.kernel_ms(dig_fn, f"digest_div_flat C={c} {tag}"),
            bound_ms=1e3 * max((4 * c * n + 16 * (c + 1)) / PEAK_BYTES_S,
                               4 * c * n / PEAK_ALU_OPS_S))
    timed["fedavg_flat"][f"leaf_{big}"]["plain_ms"] = timing.kernel_ms(
        lambda: fedavg_ref.fedavg_flat_ref(x_big, uniform),
        f"fedavg_flat plain C={c} leaf_{big}")
    timed["fedavg_flat"][f"leaf_{big}"]["library_ms"] = timing.kernel_ms(
        lambda: torch.mm(uniform[None], x_big),
        f"fedavg_flat library (torch.mm) C={c} leaf_{big}")
    timed["digest_div_flat"][f"leaf_{big}"]["plain_ms"] = timing.kernel_ms(
        lambda: fedavg_ref.digest_div_flat_ref(x_big),
        f"digest_div_flat plain C={c} leaf_{big}")
    prev, digest, offset = (torch.full((), val, dtype=torch.int64,
                                       device=dev)
                            for val in (0x1357BDF, 0x2468ACE, 7 << 20))
    timed["pow_race"][f"seal_C{c}"] = dict(
        ms=timing.kernel_ms(lambda: pow_ops.mine_seal(
            prev, digest, c, attempts, nonce_offset=offset,
            difficulty_bits=2), f"mine_seal C={c} x {attempts}"),
        bound_ms=1e3 * OPS_PER_HASH * c * attempts / PEAK_ALU_OPS_S)
    del xs, x_big
    _free(torch)
    # phi4-mini's tied embedding (200 064 x 3072, 615 M floats a client),
    # the widest leaf of the phase-7e path: held, then timed
    n = PHI4_EMBED
    x = torch.randn((c, n), generator=gen, device=dev)
    want = fedavg_ref.fedavg_flat_ref(x, uniform)
    err = (fedavg_ops.fedavg_flat(x, uniform) - want).abs()
    require(bool((err <= FLOAT_ATOL + FLOAT_RTOL * want.abs()).all()),
            f"fedavg_flat off tolerance at C={c} on phi4's embedding")
    fed_err = max(fed_err, float(err.max()))
    del err, want
    dig_err = max(dig_err, check_digest(torch, x, f"C={c} phi4 embedding"))
    tag = f"phi4_leaf_{n}"
    timed["fedavg_flat"][tag] = dict(
        ms=timing.kernel_ms(lambda: fedavg_ops.fedavg_flat(x, uniform),
                            f"fedavg_flat C={c} {tag}", reps=5),
        bound_ms=1e3 * max((8 * c * n + 16 * c) / PEAK_BYTES_S,
                           2 * c * n / PEAK_ALU_OPS_S),
        library_ms=timing.kernel_ms(lambda: torch.mm(uniform[None], x),
                                    f"fedavg_flat library (torch.mm) C={c} "
                                    f"{tag}", reps=5))
    timed["digest_div_flat"][tag] = dict(
        ms=timing.kernel_ms(lambda: fedavg_ops.digest_div_flat(x),
                            f"digest_div_flat C={c} {tag}", reps=5),
        bound_ms=1e3 * max((4 * c * n + 16 * (c + 1)) / PEAK_BYTES_S,
                           4 * c * n / PEAK_ALU_OPS_S))
    del x
    _free(torch)
    for name, rows in timed.items():
        report[name]["at_lm_train"] = rows
    print(f"phase 7b ok: at C = {c} on the {len(widths)} leaves of "
          f"xLSTM-125M at {XLSTM_TRAIN_LAYERS} layers "
          f"({elems} floats a client, the widest {widest} of {big}) and "
          f"phi4-mini's embedding ({PHI4_EMBED} floats), "
          f"fedavg_flat (uniform and weighted, with and without noise) "
          f"within rtol {FLOAT_RTOL} (largest deviation {fed_err:.3g}), "
          f"digest_div_flat within its tolerance (largest deviation "
          f"{dig_err:.3g}), mine_seal x {attempts} bitwise at two offsets; "
          f"times " + json.dumps(timed), flush=True)


def lm_ledger_head(hist):
    """The head hash of the ledger a run's history rebuilds."""
    from repro_torch.core import chain

    return chain.ledger_from_scan(
        *([h[key] for h in hist]
          for key in ("digest", "winner", "nonce", "pow_hash"))).head_hash


def drive_lm_path(torch, dev, flags, want, what, cfg=None):
    """An LM arch run of ``launch.train`` (of ``cfg`` if given, else the
    config ``flags`` name) by the graph driver and by the loop driver
    (``jit=False``; the graphs' memory pool released between the two,
    ``rounds.release_graphs``): each run's launch counts exactly
    ``want`` (every other kernel 0), the two bitwise equal (params, every
    per-round metric, the ledger's head), the ledger valid with a block a
    round, finite losses and params. Returns (args, (result, state,
    history, launches, LAST_GRAPH) of the graph run, the loop run's
    result)."""
    from repro_torch import kernels
    from repro_torch.core import rounds
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}

    def run(args, jit):
        return train.train_arch(args, jit, cfg)

    result, state, hist, launches = counted_run(torch, args, True, run)
    graph = dict(rounds.LAST_GRAPH)
    rounds.release_graphs(dev)
    _free(torch)
    lresult, lstate, lhist, llaunches = counted_run(torch, args, False, run)
    for driver, res, counts in (("graph", result, launches),
                                ("loop", lresult, llaunches)):
        require(res["dispatch"]["driver"] == driver,
                f"the {what} ran on {res['dispatch']}, expected {driver}")
        require(counts == want and res["launches"] == want,
                f"launch counts {counts} on the {what} ({driver} driver), "
                f"expected {want}")
        require(res["chain_valid"] and res["blocks"] == args.rounds,
                f"ledger not valid on the {what} ({driver}): {res}")
    require(json.dumps(hist) == json.dumps(lhist)
            and torch.equal(state.prev_hash, lstate.prev_hash)
            and lm_ledger_head(hist) == lm_ledger_head(lhist)
            and all(torch.equal(v, lstate.params[k])
                    for k, v in state.params.items()),
            f"graph and loop drivers differ on the {what}")
    del lstate
    require(all(math.isfinite(h[key]) for h in hist
                for key in ("local_loss_mean", "global_loss", "divergence")),
            f"non-finite metrics on the {what}: {hist}")
    require(all(math.isfinite(v.float().abs().sum().item())
                for v in state.params.values()),
            f"non-finite params on the {what}")
    return args, (result, state, hist, launches, graph), lresult


def profile_lm_replays(torch, args, profile_dir, name, cfg=None):
    """Profile the K - 1 replays of a fresh capture of the LM arch path
    ``args`` selects (of ``cfg`` if given): the device's busy share and
    its operations a round; the table goes to
    ``profile_rounds_<name>.txt``."""
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch.benchmarks import timing
    from repro_torch.core import rounds
    from repro_torch.launch import train
    from repro_torch.models import registry

    cfg, spec, src, params, dev = train.prepare_arch(args, cfg)
    captured = rounds.CapturedRounds(rounds.RoundRunner(
        registry.client_losses(cfg), spec, params, args.rounds,
        seed=args.seed + 2, device=dev, stacked=True),
        src.stacked_batches(args.rounds))
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        captured.replay()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    n = args.rounds - 1
    busy_ms = timing.device_us(p) / 1e3
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"profile_rounds_{name}.txt")
    with open(path, "w") as f:
        f.write(p.key_averages().table(sort_by="cuda_time_total",
                                       row_limit=40))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "rounds": n,
            "device_ops_a_round": timing.device_ops(p) / n, "table": path}


def xlstm_one_period():
    """``configs/xlstm_125m.py``'s ONE_H100 (the published 12 layers) cut
    to its first XLSTM_TRAIN_LAYERS, one period of its pattern, every
    width kept: the config phase 7c trains."""
    import dataclasses

    from repro_torch.configs import get_one_h100_arch

    return dataclasses.replace(get_one_h100_arch("xlstm-125m"),
                               name=f"xlstm-125m-{XLSTM_TRAIN_LAYERS}l",
                               n_layers=XLSTM_TRAIN_LAYERS)


def phase_lm_train(torch, dev, profile_dir):
    """Phase 7c: ``launch.train --arch xlstm-125m --size one-h100`` at
    XLSTM_TRAIN_ARGS, its config cut to one period of its pattern
    (``xlstm_one_period``), by both drivers (``drive_lm_path``): the seal
    K times, ``fedavg_flat`` and ``digest_div_flat`` once a leaf a round,
    flash, the scan and the mix never; no host sync in the loop's rounds
    nor in the replays of those two runs (``watched_rounds``). Prints the
    ms a round by each driver and of a replay, the warm round's and the
    captures' seconds and the peak of allocated device memory; with
    ``profile_dir``, the replays' busy share (``profile_lm_replays``).
    Returns the graph run's launches."""
    what = (f"xLSTM-125M training path ({XLSTM_TRAIN_LAYERS} of 12 "
            "layers)")
    cfg = xlstm_one_period()
    n_leaves = len(train_leaf_widths(torch, dev, cfg))
    want = {"pow_race": K_TRAIN, "fedavg_flat": n_leaves * K_TRAIN,
            "digest_div_flat": n_leaves * K_TRAIN}
    with watched_rounds(torch) as syncs:
        args, (result, state, hist, launches, graph), lresult = \
            drive_lm_path(torch, dev, XLSTM_TRAIN_ARGS, want, what, cfg)
    n_params = sum(v[0].numel() for v in state.params.values())
    del state
    _free(torch)
    profiled = (profile_lm_replays(torch, args, profile_dir, "xlstm_train",
                                   cfg)
                if profile_dir else None)
    replay_ms = 1e3 * syncs["seconds"]["replays"] / (K_TRAIN - 1)
    for key in ("loop", "replays"):
        require(not syncs[key], f"{len(syncs[key])} host syncs in the "
                                f"{key} of the {what}: {syncs[key][:3]}")
    print("phase 7c ok: " + json.dumps(
        {"path": what, "parameters": n_params, "leaves": n_leaves,
         "launches": launches, "dispatch": result["dispatch"],
         "drivers_bitwise_equal": True,
         "loss_curve": result["loss_curve"],
         "local_loss_mean": [h["local_loss_mean"] for h in hist],
         "round_ms": {"graph": 1e3 * result["wall_s"] / K_TRAIN,
                      "loop": 1e3 * lresult["wall_s"] / K_TRAIN,
                      "replay": replay_ms},
         "graph_setup_s": {key: graph[key] for key in
                           ("warm_s", "capture_s", "graphs", "replays")},
         "peak_mem_gb": {"graph": result["peak_mem_gb"],
                         "loop": lresult["peak_mem_gb"]},
         "host_syncs": {key: len(syncs[key])
                        for key in ("loop", "setup", "replays")},
         "profile_replays": profiled}), flush=True)
    return launches


def held_to_cpu(torch, args, state, hist, what):
    """The run ``args`` made on the card (``state``, ``hist``) made again
    on the CPU: every per-round metric and the aggregate within rtol
    CARD_CPU_RTOL / atol CARD_CPU_ATOL, each client's params within
    CLIENT_SPREAD_LIMIT times it. Returns (the worst share of the
    tolerance by key, the per-client params' worst)."""
    from repro_torch.core import aggregation
    from repro_torch.launch import train

    cpu_args = argparse.Namespace(**{**vars(args), "device": "cpu"})
    _, cpu_state, cpu_hist = train.train_arch(cpu_args)

    def ratio(a, b):   # |a - b| over the tolerance at b; <= 1 passes
        a = torch.as_tensor(a, dtype=torch.float64).cpu()
        b = torch.as_tensor(b, dtype=torch.float64)
        return float(((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                       * b.abs())).max())

    gated = {key: max(ratio(a[key], b[key]) for a, b in zip(hist, cpu_hist))
             for key in ("local_loss_mean", "global_loss", "divergence")}
    agg = aggregation.aggregate_once(state.params)
    cpu_agg = aggregation.aggregate_once(cpu_state.params)
    gated["aggregate"] = max(ratio(v, cpu_agg[k]) for k, v in agg.items())
    clients = max(ratio(v, cpu_state.params[k])
                  for k, v in state.params.items())
    require(all(r <= 1 for r in gated.values())
            and clients <= CLIENT_SPREAD_LIMIT,
            f"the {what} differs between card and cpu: {gated}, per-client "
            f"params {clients:.3g} (limit {CLIENT_SPREAD_LIMIT})")
    return gated, clients


def phase_lm_microbatches(torch, dev):
    """Phase 7d: XLSTM_MB_ARGS (xlstm-125m smoke, each client's batch in 2
    microbatches under activation checkpointing) by both drivers, bitwise
    equal with exact launch counts; then the same run on the CPU
    (``held_to_cpu``)."""
    from repro_torch.launch import train

    args = train.build_parser().parse_args(XLSTM_MB_ARGS
                                           + ["--device", str(dev)])
    _, _, _, params, _ = train.prepare_arch(args)
    n = len(params)
    del params
    want = {"pow_race": K_TRAIN_SMOKE, "fedavg_flat": n * K_TRAIN_SMOKE,
            "digest_div_flat": n * K_TRAIN_SMOKE}
    what = "xLSTM smoke path with 2 microbatches"
    args, (result, state, hist, launches, _), _ = drive_lm_path(
        torch, dev, XLSTM_MB_ARGS, want, what)
    gated, clients = held_to_cpu(torch, args, state, hist, what)
    print("phase 7d ok: " + json.dumps(
        {"path": what, "launches": launches, "drivers_bitwise_equal": True,
         "card_vs_cpu_worst_of_tolerance": gated,
         "per_client_params_worst": clients,
         "loss_curve": result["loss_curve"]}), flush=True)


def arch_train_launches(cfg, n_leaves, k, c, tau=2):
    """The launches of K rounds of an LM arch on the FullMesh round with
    eval every round: the seal once a round, ``fedavg_flat`` and
    ``digest_div_flat`` once a leaf a round; each attention (flash) and
    Mamba (scan) layer one forward a client a local step and one for the
    round's global loss, one backward a client a local step."""
    kinds = cfg.layer_kinds()
    fwd, bwd = k * c * (tau + 1), k * c * tau
    return {"pow_race": k, "fedavg_flat": n_leaves * k,
            "digest_div_flat": n_leaves * k,
            "flash_attention": kinds.count("attn") * fwd,
            "flash_attention_bwd": kinds.count("attn") * bwd,
            "ssm_scan": kinds.count("ssm") * fwd,
            "ssm_scan_bwd": kinds.count("ssm") * bwd}


def phase_phi4_train(torch, dev, profile_dir):
    """Phase 7e: ``launch.train --arch phi4-mini-3.8b --size one-h100`` at
    PHI4_TRAIN_ARGS (the published widths, 2 layers) by both drivers
    (``drive_lm_path``), bitwise equal: the launches exact
    (``arch_train_launches``: flash forward and backward, the FL kernels
    once a leaf a round), no host sync in the loop's rounds nor in the
    replays, the peak of allocated memory under PHI4_PEAK_GB. Prints the
    ms a round by each driver and of a replay, the warm round's and the
    capture's seconds and the peaks; with ``profile_dir`` the replays'
    busy share. Returns the graph run's launches."""
    from repro_torch import tree
    from repro_torch.configs import get_one_h100_arch, get_smoke_arch
    from repro_torch.core import rounds
    from repro_torch.models import registry

    cfg = get_one_h100_arch("phi4-mini-3.8b")
    what = "phi4-mini-3.8B training path (2 of 32 layers)"
    # the leaves of the smoke config, whose layers and kinds are the cut's
    smoke = get_smoke_arch("phi4-mini-3.8b")
    require(smoke.layer_kinds() == cfg.layer_kinds(),
            "phi4-mini's smoke and one-H100 configs differ in layers")
    n_leaves = len(tree.flatten(registry.init_model(
        torch.Generator().manual_seed(0), smoke)))
    want = arch_train_launches(cfg, n_leaves, K_PHI4, PHI4_CLIENTS)
    # the earlier phases' graph pool goes back first
    rounds.release_graphs(dev)
    _free(torch)
    with watched_rounds(torch) as syncs:
        args, (result, state, hist, launches, graph), lresult = \
            drive_lm_path(torch, dev, PHI4_TRAIN_ARGS, want, what)
    n_params = sum(v[0].numel() for v in state.params.values())
    del state
    _free(torch)
    for key in ("loop", "replays"):
        require(not syncs[key], f"{len(syncs[key])} host syncs in the "
                                f"{key} of the {what}: {syncs[key][:3]}")
    peaks = {"graph": result["peak_mem_gb"], "loop": lresult["peak_mem_gb"]}
    require(max(peaks.values()) <= PHI4_PEAK_GB,
            f"the {what} peaked at {peaks} GB (limit {PHI4_PEAK_GB})")
    profiled = (profile_lm_replays(torch, args, profile_dir, "phi4_train")
                if profile_dir else None)
    print("phase 7e ok: " + json.dumps(
        {"path": what, "parameters": n_params, "leaves": n_leaves,
         "launches": launches, "dispatch": result["dispatch"],
         "drivers_bitwise_equal": True,
         "loss_curve": result["loss_curve"],
         "local_loss_mean": [h["local_loss_mean"] for h in hist],
         "round_ms": {"graph": 1e3 * result["wall_s"] / K_PHI4,
                      "loop": 1e3 * lresult["wall_s"] / K_PHI4,
                      "replay": 1e3 * syncs["seconds"]["replays"]
                      / (K_PHI4 - 1)},
         "graph_setup_s": {key: graph[key] for key in
                           ("warm_s", "capture_s", "graphs", "replays")},
         "peak_mem_gb": peaks,
         "host_syncs": {key: len(syncs[key])
                        for key in ("loop", "setup", "replays")},
         "profile_replays": profiled}), flush=True)
    return launches


def phase_smoke_archs_train(torch, dev):
    """Phase 7f: each of SMOKE_TRAIN_ARCHS at its smoke config
    (SMOKE_TRAIN_ARGS) trained on the card by the graph driver: its
    launches exactly ``arch_train_launches`` (flash and the scan, forward
    and backward, as its layer pattern gives them), a valid chain, finite
    losses; then held to its CPU run (``held_to_cpu``). Returns {arch:
    launches}."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke_arch
    from repro_torch.launch import train

    out, summary = {}, {}
    for arch in SMOKE_TRAIN_ARCHS:
        what = f"{arch} smoke training path"
        args = train.build_parser().parse_args(
            ["--arch", arch] + SMOKE_TRAIN_ARGS + ["--device", str(dev)])
        n_leaves = len(train.prepare_arch(args)[3])
        want = {**{name: 0 for name in kernels.WRAPPERS},
                **arch_train_launches(get_smoke_arch(arch), n_leaves,
                                      K_TRAIN_SMOKE, TRAIN_CLIENTS)}
        result, state, hist, launches = counted_run(torch, args, True,
                                                    train.train_arch)
        require(result["dispatch"]["driver"] == "graph",
                f"the {what} ran on {result['dispatch']}")
        require(launches == want and result["launches"] == want,
                f"launch counts {launches} on the {what}, expected {want}")
        require(result["chain_valid"] and result["blocks"] == args.rounds,
                f"ledger not valid on the {what}: {result}")
        require(all(math.isfinite(h[key]) for h in hist
                    for key in ("local_loss_mean", "global_loss")),
                f"non-finite losses on the {what}: {hist}")
        gated, clients = held_to_cpu(torch, args, state, hist, what)
        out[arch] = launches
        summary[arch] = {
            "launches": {k: v for k, v in launches.items() if v},
            "card_vs_cpu_worst_of_tolerance": max(gated.values()),
            "per_client_params_worst": clients,
            "loss_curve": result["loss_curve"]}
        del state
        _free(torch)
    print("phase 7f ok: " + json.dumps(summary), flush=True)
    return out


def _ratio(torch, a, b):
    """|a - b| over the card tolerance at b; <= 1 passes."""
    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    return float(((a - b).abs() / (CARD_CPU_ATOL + CARD_CPU_RTOL
                                   * b.abs())).max())


# why a gather-tier path may miss bitwise on the card: the rank's work
# runs at C/D clients, and the card's kernels for a batch of C/D rows
# (cuBLAS's GEMMs, the reductions of each client's loss) may sum in
# another order than for C
ROWS_SPREAD = ("a rank's kernels run on C/D clients' rows, and the card's "
               "GEMMs and reductions may sum in another order at C/D rows "
               "than at C")
PSUM_SPREAD = ("the psum tier sums per-rank partials (fp32 reassociated), "
               "so params and digests differ in the last bits")


def held_to_one_process(torch, what, got, want, consensus,
                        why=ROWS_SPREAD):
    """A sharded run (``got``: its result, final params, history) held to
    the one-process run of the same flags on the card (``want``): bitwise
    (params, every metric, the ledger), or else within rtol CARD_CPU_RTOL
    / atol CARD_CPU_ATOL on every per-round metric, the aggregate and the
    eval loss, each client's params within that (``consensus``) or
    CLIENT_SPREAD_LIMIT times it. Either way both chains validate, and in
    each round up to which every digest agreed (so the same ledger head
    was mined on) the mining integers agree. Returns {"held": "bitwise" |
    "tolerance", ...}."""
    from repro_torch.core import aggregation

    (result, params, hist), (wresult, wparams, whist) = got, want
    require(result["chain_valid"] and wresult["chain_valid"]
            and result["blocks"] == wresult["blocks"],
            f"ledger not valid on the {what}: {result}")
    same_chain = 0   # rounds whose digest, and every earlier one, agree
    while same_chain < len(hist) and \
            hist[same_chain]["digest"] == whist[same_chain]["digest"]:
        same_chain += 1
    mining_fields = ("winner", "nonce", "pow_hash", "solved")
    require(all(h[k] == w[k] for h, w in zip(hist[:same_chain],
                                             whist[:same_chain])
                for k in mining_fields),
            f"equal digests but other mining results on the {what}")
    params_bitwise = all(torch.equal(params[k].cpu(), v.cpu())
                         for k, v in wparams.items())
    differ = sorted({key for h, w in zip(hist, whist) for key in h
                     if json.dumps(h[key]) != json.dumps(w[key])})
    if params_bitwise and not differ:
        return {"held": "bitwise"}
    gated = {key: max(_ratio(torch, h[key], w[key])
                      for h, w in zip(hist, whist))
             for key in ("local_loss_mean", "global_loss", "divergence")}
    if "final_eval_loss" in result:
        gated["final_eval_loss"] = _ratio(torch, result["final_eval_loss"],
                                          wresult["final_eval_loss"])
    agg = aggregation.aggregate_once({k: v.cpu() for k, v in params.items()})
    wagg = aggregation.aggregate_once({k: v.cpu()
                                       for k, v in wparams.items()})
    gated["aggregate"] = max(_ratio(torch, v, wagg[k])
                             for k, v in agg.items())
    limit = 1.0 if consensus else CLIENT_SPREAD_LIMIT
    clients = max(_ratio(torch, v, wparams[k]) for k, v in params.items())
    require(all(r <= 1 for r in gated.values()) and clients <= limit,
            f"the {what} differs from its one-process run beyond rtol "
            f"{CARD_CPU_RTOL} atol {CARD_CPU_ATOL}: {gated}, per-client "
            f"params {clients:.3g} (limit {limit})")
    return {"held": "tolerance", "why": why,
        "params_bitwise": params_bitwise, "metrics_that_differ": differ,
        "rounds_on_one_chain": same_chain,
        "worst_of_tolerance": gated, "per_client_params_worst": clients,
        "per_client_limit": limit}


def one_process(torch, flags, dev, run="mlp"):
    """``launch.train`` with ``flags`` in this process on the card by the
    loop driver (the driver gloo ranks run): (result, params, history)."""
    from repro_torch.launch import train

    args = train.build_parser().parse_args(flags + ["--device", str(dev)])
    if run == "cohort":
        result, _, hist = train.train_cohort(args)
        return result, None, hist
    fn = train.train_mlp if run == "mlp" else train.train_arch
    result, state, hist = fn(args, jit=False)
    return result, {k: v.cpu() for k, v in state.params.items()}, hist


def check_rank_launches(result, want, what):
    """Every rank of a sharded run launched exactly ``want``."""
    from repro_torch import kernels

    want = {**{name: 0 for name in kernels.WRAPPERS}, **want}
    for stats in result["by_rank"]:
        require(stats["launches"] == want,
                f"rank {stats['rank']} of the {what} launched "
                f"{stats['launches']}, expected {want}")


def sharded_paths_rank(paths, device):
    """One rank of phase 8b's 2-rank gloo world: a warm run of the paper's
    path (the first collectives, cuBLAS's handles and the kernels' loads
    happen there), then each of ``paths`` (name -> (flags, run kind))
    through the trainer's functions on this rank's mesh; returns {name:
    (result, params on the CPU, history)}."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    out = {}
    for name, (flags, run) in [("warm", (MAIN_ARGS, "mlp")),
                               *paths.items()]:
        args = train.build_parser().parse_args(flags + SHARD_GLOO
                                               + ["--device", device])
        mesh = mesh_lib.make_client_mesh(args.devices, device)
        if run == "cohort":
            result, _, hist = train.train_cohort(args, mesh=mesh)
            params = None
        else:
            fn = train.train_mlp if run == "mlp" else train.train_arch
            result, state, hist = fn(args, True, mesh=mesh)
            params = {k: v.cpu() for k, v in state.params.items()}
        result["mesh"] = train._mesh_fields(mesh)
        out[name] = (result, params, hist)
    del out["warm"]
    return out


def _summary(result):
    return {"round_ms_by_rank": [r["round_ms"] for r in result["by_rank"]],
            "launches_by_rank": [{k: v for k, v in r["launches"].items()
                                  if v} for r in result["by_rank"]],
            "received_bytes_per_round_by_rank": [
                r["received_bytes_per_round"] for r in result["by_rank"]],
            "dispatch": result["dispatch"]}


def phase_sharded(torch, dev):
    """Phase 8: the client-sharded engine on the card. 8a the paper's path
    (MAIN_ARGS) over SHARD_RANKS gloo ranks, gather tier, through the
    trainer's own spawn, each rank's launches exact, held to the
    one-process loop run (``held_to_one_process``), each rank's round ms,
    analytic bytes received a round and the collectives' transports
    printed; 8b SHARDED_PATHS, the cohort path and SHARD_ARCH over the same
    ranks (one world), the cluster layout on 4 ranks, each held to its
    one-process run (the arch to its run over 1 rank), launches exact on
    every rank; 8c the paper's path over 1 NCCL rank, on the graph driver
    with its collectives captured, bitwise the one-process graph run.
    Returns {path: rank 0's launches}."""
    from repro_torch import tree
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import rounds
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import registry

    rounds.release_graphs(dev)
    _free(torch)
    by_path = {}
    fl = {"pow_race": K, "fedavg_flat": 4 * K, "digest_div_flat": 4 * K}

    # 8a: the paper's path over 2 gloo ranks, through the trainer's spawn
    what = f"paper's path over {SHARD_RANKS} gloo ranks"
    args = train.build_parser().parse_args(MAIN_ARGS + SHARD_GLOO
                                           + ["--device", str(dev)])
    t0 = time.perf_counter()
    result, state, hist = train.train_mlp(args)
    spawn_s = time.perf_counter() - t0
    require(result["dispatch"]["driver"] == "loop",
            f"the {what} ran on {result['dispatch']}")
    check_rank_launches(result, fl, what)
    held = held_to_one_process(torch, what, (result, state.params, hist),
                               one_process(torch, MAIN_ARGS, dev), True)
    by_path["sharded paper (rank 0)"] = result["by_rank"][0]["launches"]
    print("phase 8a ok: " + json.dumps(
        {"path": what, **_summary(result), "mesh": result["mesh"],
         "note": "the ranks' first run: its round ms hold their first "
                 "collectives, cuBLAS's handles and the kernels' loads "
                 "(8b's paper's path is read on warm ranks)",
         "trainer_wall_s_with_spawn": spawn_s, **held}), flush=True)

    # 8b: the other paths over the same 2 ranks, in one world
    n_leaves = len(tree.flatten(registry.init_model(
        torch.Generator().manual_seed(0), get_smoke_arch(SHARD_ARCH))))
    arch_want = arch_train_launches(
        get_smoke_arch(SHARD_ARCH), n_leaves, K_TRAIN_SMOKE,
        TRAIN_CLIENTS // SHARD_RANKS)
    paths = {name: (flags, "mlp")
             for name, (flags, _, _) in SHARDED_PATHS.items()}
    paths["cohort 64 of 10 000"] = (SHARD_COHORT_ARGS, "cohort")
    paths[f"{SHARD_ARCH} smoke --arch"] = (SHARD_ARCH_ARGS, "arch")
    t0 = time.perf_counter()
    ranks = mesh_lib.run_world(sharded_paths_rank, SHARD_RANKS,
                               backend="gloo", device=str(dev),
                               args=(paths, str(dev)))
    world_s = time.perf_counter() - t0
    summary = {}
    for name, (flags, run) in paths.items():
        result, params, hist = ranks[0][name]
        result["by_rank"] = [rank[name][0]["rank_stats"] for rank in ranks]
        for rank in ranks[1:]:
            require(json.dumps(rank[name][2]) == json.dumps(hist),
                    f"the ranks' histories differ on the {name} path")
        if name in SHARDED_PATHS:
            _, consensus, per_round = SHARDED_PATHS[name]
            want = {k: v * K for k, v in per_round.items()}
            held = held_to_one_process(
                torch, name, (result, params, hist),
                one_process(torch, flags, dev), consensus,
                PSUM_SPREAD if "--fast-allreduce" in flags else ROWS_SPREAD)
        elif run == "cohort":
            want = fl
            wresult, _, whist = one_process(torch, flags, dev, "cohort")
            require([h["cohort"] for h in hist]
                    == [h["cohort"] for h in whist],
                    f"the {name} path drew other cohorts")
            held = held_to_one_process(
                torch, name, (result, {"_": torch.zeros(1)},
                              [{k: v for k, v in h.items() if k != "cohort"}
                               for h in hist]),
                (wresult, {"_": torch.zeros(1)},
                 [{k: v for k, v in h.items() if k != "cohort"}
                  for h in whist]), True)
        else:
            want = arch_want
            one = train.build_parser().parse_args(
                flags + ["--devices", "1", "--backend", "gloo",
                         "--device", str(dev)])
            oresult, ostate, ohist = train.train_arch(one)
            held = held_to_one_process(
                torch, name, (result, params, hist),
                (oresult, ostate.params, ohist), True)
        check_rank_launches(result, want, name)
        by_path[f"sharded {name} (rank 0)"] = result["by_rank"][0]["launches"]
        summary[name] = {**_summary(result), **held}
    print("phase 8b: " + json.dumps({"world_s_with_spawn": world_s,
                                     "transport": ranks[0][next(iter(
                                         paths))][0]["mesh"]["transport"]}),
          flush=True)

    what = "cluster:2 over 4 gloo ranks (2 pods of 2)"
    args = train.build_parser().parse_args(CLUSTER_ARGS
                                           + ["--device", str(dev)])
    result, state, hist = train.train_mlp(args)
    require(result["dispatch"]["mix_mode"] == "exec_cluster"
            and result["mesh"]["shape"] == [2, 2],
            f"the {what} ran {result['dispatch']} on {result['mesh']}")
    check_rank_launches(result, {"pow_race": K, "digest_div_flat": 4 * K},
                        what)
    held = held_to_one_process(
        torch, what, (result, state.params, hist),
        one_process(torch, MAIN_ARGS + ["--topology", "cluster:2"], dev),
        False)
    by_path["sharded cluster (rank 0)"] = result["by_rank"][0]["launches"]
    summary[what] = {**_summary(result), **held}
    print("phase 8b ok: " + json.dumps(summary), flush=True)

    # 8c: one NCCL rank, the graph driver capturing its collectives
    what = "paper's path over 1 NCCL rank (graph driver)"
    args = train.build_parser().parse_args(
        MAIN_ARGS + ["--devices", "1", "--backend", "nccl",
                     "--device", str(dev)])
    result, state, hist = train.train_mlp(args)
    require(result["dispatch"]["driver"] == "graph",
            f"the {what} ran on {result['dispatch']}")
    check_rank_launches(result, fl, what)
    wargs = train.build_parser().parse_args(MAIN_ARGS
                                            + ["--device", str(dev)])
    wresult, wstate, whist = train.train_mlp(wargs)
    require(wresult["dispatch"]["driver"] == "graph",
            f"the one-process paper's path ran on {wresult['dispatch']}")
    require(json.dumps(hist) == json.dumps(whist)
            and all(torch.equal(state.params[k], v.cpu())
                    for k, v in wstate.params.items()),
            f"the {what} is not bitwise the one-process graph run")
    by_path["sharded nccl paper (rank 0)"] = result["by_rank"][0]["launches"]
    print("phase 8c ok: " + json.dumps(
        {"path": what, **_summary(result), "mesh": result["mesh"],
         "held": "bitwise"}), flush=True)
    rounds.release_graphs(dev)
    _free(torch)
    return by_path


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# the kernels of MoE's routing and dispatch (``moe.route``, the scatter
# into the expert buffer and the gather back): softmax, the sort (top-k),
# the one-hot compare, the cumsum, index_put / gather / indexing; the
# token embedding's gather falls in with them (one [B S, D] copy)
ROUTING_KERNELS = ("softmax", "sort", "compareeq", "scan", "index", "gather",
                   "scatter", "where")


def kernel_class(name):
    """The class of a device kernel by its name: gemm, flash_attention,
    ssm_scan, moe_routing or other."""
    name = name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "ssm_scan_kernel" in name:
        return "ssm_scan"
    if "gemm" in name or "cutlass" in name or "matmul" in name:
        return "gemm"
    if any(key in name for key in ROUTING_KERNELS):
        return "moe_routing"
    return "other"


def prefill_breakdown(torch, params, cfg, batch, profile_dir, tag):
    """Profile one prefill of ``batch`` (``profile_breakdown``)."""
    from repro_torch.models import transformer

    profile_breakdown(torch, lambda: transformer.prefill(params, cfg, batch),
                      profile_dir, f"prefill_{tag}")


def profile_breakdown(torch, run, profile_dir, tag):
    """Profile ``run()``; print its device time by class of kernel
    (``kernel_class``), its device operations, its busy share of the wall
    time and the host time inside each recurrent block kind's mixers (the
    forward's ``mixer:<kind>`` ranges), and write the full table, and each
    class's kernels by time, into ``profile_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from repro_torch.models import transformer

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    classes = {"gemm": 0.0, "flash_attention": 0.0, "ssm_scan": 0.0,
               "moe_routing": 0.0, "other": 0.0}
    by_kernel, n_ops, mixers = {}, 0, {}
    for e in p.events():
        if e.name.startswith(transformer.MIXER_RANGE):
            if e.device_type == DeviceType.CPU:
                mixers[e.name] = (mixers.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        n_ops += 1
        ms = e.time_range.elapsed_us() / 1e3
        key = kernel_class(e.name)
        classes[key] += ms
        by_kernel[(key, e.name)] = by_kernel.get((key, e.name), 0.0) + ms
    busy = sum(classes.values())
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"profile_{tag}.txt")
    with open(path, "w") as f:
        f.write(p.key_averages().table(sort_by="cuda_time_total",
                                       row_limit=40))
        f.write("\ndevice ms by class and kernel:\n")
        for (key, name), ms in sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1]):
            f.write(f"{key:16s} {ms:12.4f}  {name[:160]}\n")
    print(f"profile ({tag}): " + json.dumps(
        {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
         "busy_share": busy / wall_ms, "device_ops": n_ops,
         "device_ms_by_class": classes,
         "share_by_class": {k: v / busy if busy else None
                            for k, v in classes.items()},
         "host_ms_by_mixer": mixers,
         "host_share_by_mixer": {k: v / wall_ms for k, v in mixers.items()}})
        + f"; table in {path}", flush=True)


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
                         "each serve path, and write the tables into DIR")
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
    torch.cuda.empty_cache()
    lap("phase 4b")
    _, mlaunches = phase_serve(torch, dev, MLA_SERVE_ARGS,
                               MLA_SERVE_LAUNCHES, "4c")
    torch.cuda.empty_cache()
    lap("phase 4c")
    phase_mla_agreement(torch, dev, opts.profile)
    torch.cuda.empty_cache()
    lap("phase 4d")
    xlaunches = phase_xlstm(torch, dev, opts.profile)
    _free(torch)
    lap("phase 4e")
    vlaunches = phase_vlm(torch, dev, opts.profile)
    _free(torch)
    lap("phase 4f")
    alaunches = phase_audio(torch, dev, opts.profile)
    _free(torch)
    lap("phase 4g")
    phase_sweep(torch, dev)
    lap("phase 5")
    clau, dclau = phase_cohort(torch, dev, report, opts.profile)
    lap("phase 6")
    phase_train_grads(torch, dev, report)
    lap("phase 7a")
    phase_bwd_times(torch, dev, report)
    phase_train_kernels(torch, dev, report)
    lap("phase 7b")
    tlaunches7 = phase_lm_train(torch, dev, opts.profile)
    _free(torch)
    lap("phase 7c")
    phase_lm_microbatches(torch, dev)
    _free(torch)
    lap("phase 7d")
    plaunches = phase_phi4_train(torch, dev, opts.profile)
    _free(torch)
    lap("phase 7e")
    smoke_trains = phase_smoke_archs_train(torch, dev)
    lap("phase 7f")
    sharded = phase_sharded(torch, dev)
    lap("phase 8")

    by_path = {"paper": launches, "topology": tlaunches, "serve": slaunches,
               "mla serve": mlaunches, "xlstm serve": xlaunches,
               "vlm serve": vlaunches, "audio encoder": alaunches,
               "cohort": clau, "dense cohort": dclau,
               "xlstm train": tlaunches7, "phi4 train": plaunches,
               **{f"{arch} smoke train": counts
                  for arch, counts in smoke_trains.items()},
               **sharded}
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
