#!/usr/bin/env python3
"""Sweep the build-time choices of the selective-scan kernels on one NVIDIA
GPU. The forward (``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu``):
states per lane (``REPRO_SSM_STATES_PER_LANE``), time steps per staged
chunk (``REPRO_SSM_CHUNK``) and channels per block
(``REPRO_SSM_CHANNELS``). With ``--backward``, the backward
(``csrc/ssm_scan_bwd.cu``): states per lane
(``REPRO_SSM_BWD_STATES_PER_LANE``), the chunk's recomputed states in
registers or shared memory (``REPRO_SSM_BWD_SMEM_STATES``) and the blocks
an SM is asked to hold, which caps the registers
(``REPRO_SSM_BWD_MIN_BLOCKS``).

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/ssm_scan_sweep.py [--backward] [--out FILE]

Each variant is built with ``nvcc`` (all at once) into
``build/repro_torch/sweep/``, checked against the plain version at a small
case and at the path's shape (the forward at the serve path's Mamba shape,
B 4, T 2048, d_in 16384, ds 16, atol 2e-5 + rtol 1e-5; the backward at
Jamba's training layer, B 2, T 512, d_in 16384, ds 16, against autograd of
the plain version at rtol 1e-4 + atol 2e-5 of max|want|, ``chip_smoke.py``
phase 7a's gate), and timed there with CUDA events. Prints one JSON line
per variant (ms, registers, spill bytes, worst share of the tolerance) and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (states per lane, chunk, channels per block)
VARIANTS = [(16, 16, 64), (8, 16, 64), (4, 16, 64), (16, 8, 64),
            (16, 8, 32), (16, 16, 128), (16, 32, 64)]
PATH = (4, 2048, 16384, 16)
SMALL = (3, 1000, 1000, 64)
ATOL, RTOL = 2e-5, 1e-5


# the backward's (states per lane, states in shared memory, min blocks)
BWD_VARIANTS = [(4, 0, 2), (4, 1, 2), (4, 1, 3), (2, 0, 2), (2, 0, 3),
                (2, 1, 4), (8, 1, 2)]
BWD_PATH = (2, 512, 16384, 16)
BWD_SMALL = (1, 100, 300, 16)
BWD_RTOL, BWD_ATOL = 1e-4, 2e-5


def build(variants, source="ssm_scan", macros=("REPRO_SSM_STATES_PER_LANE",
                                                 "REPRO_SSM_CHUNK",
                                                 "REPRO_SSM_CHANNELS"),
          symbol="ssm_scan_kernelILi16ELb1ELb1E"):
    """Build ``source`` once a variant, each value set as the macro of the
    same place; returns (variant, library, registers, spill bytes) of the
    ds <= 16 instance ``symbol``."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for variant in variants:
        tag = "_".join(str(x) for x in variant)
        lib = out_dir / f"{source}_{tag}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               *(f"-D{m}={x}" for m, x in zip(macros, variant)), "-o",
               str(lib), str(_build.SOURCES[source])]
        procs.append((variant, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = []
    for variant, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        # the ds <= 16 instance (the path's): its registers and spills
        regs = spill = None
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if symbol in line:
                for nxt in lines[i + 1:i + 4]:
                    m = re.search(r"(\d+) bytes spill stores", nxt)
                    spill = int(m.group(1)) if m else spill
                    m = re.search(r"Used (\d+) registers", nxt)
                    regs = int(m.group(1)) if m else regs
        built.append((variant, lib, regs, spill))
    return built


def events_ms(torch, fn, reps=20):
    """Device ms a call of ``fn`` by CUDA events over ``reps`` calls."""
    for _ in range(3):
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


def sweep_backward(torch, dev):
    """Each BWD_VARIANTS build of the backward against autograd of the
    plain version at BWD_SMALL and BWD_PATH, and its time at BWD_PATH;
    returns the JSON lines."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(8642)
    cases = []
    for b, t, d_in, ds in (BWD_SMALL, BWD_PATH):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        xs = [randn(b, t, d_in), F.softplus(randn(b, t, d_in) - 2),
              randn(b, t, ds), randn(b, t, ds),
              -(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)
                * torch.exp(0.3 * randn(d_in, ds))), randn(d_in)]
        dy, dh = randn(b, t, d_in), randn(b, d_in, ds)
        with torch.no_grad():
            _, _, h_chunks = ops._launch(*xs, chunks=True)
        leaves = [x.clone().requires_grad_() for x in xs]
        want = torch.autograd.grad(ssm_scan_ref(*leaves), leaves, (dy, dh))
        cases.append((xs, h_chunks, dy, dh, want))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lines = []
    for (spl, smem, blocks), path, regs, spill in build(
            BWD_VARIANTS, "ssm_scan_bwd",
            ("REPRO_SSM_BWD_STATES_PER_LANE", "REPRO_SSM_BWD_SMEM_STATES",
             "REPRO_SSM_BWD_MIN_BLOCKS"), "scan_bwdILi16ELb1ELb1E"):
        lib = ctypes.CDLL(str(path))
        fn = lib.repro_ssm_scan_bwd
        fn.argtypes, fn.restype = ops._SIGNATURE_BWD, ctypes.c_int
        size = lib.repro_ssm_scan_bwd_workspace
        size.argtypes, size.restype = [ctypes.c_int] * 4, ctypes.c_longlong

        def run(xs, h_chunks, dy, dh):
            b, t, d_in = xs[0].shape
            ds = xs[4].shape[1]
            grads = [torch.empty_like(x) for x in xs]
            work = torch.empty(size(b, t, d_in, ds), device=dev)
            err = fn(*(x.data_ptr() for x in (*xs, h_chunks, dy, dh)),
                     *(x.data_ptr() for x in grads), work.data_ptr(),
                     ops.CHUNK, b, t, d_in, ds, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return grads

        worst = 0.0
        for xs, h_chunks, dy, dh, want in cases:
            for got, ref in zip(run(xs, h_chunks, dy, dh), want):
                tol = (BWD_RTOL * ref.abs()
                       + BWD_ATOL * ref.abs().max().clamp_min(1e-30))
                worst = max(worst, float(((got - ref).abs() / tol).max()))
        xs, h_chunks, dy, dh, _ = cases[1]
        line = json.dumps({
            "states_per_lane": spl, "states_in_smem": bool(smem),
            "min_blocks": blocks,
            "ms": events_ms(torch, lambda: run(xs, h_chunks, dy, dh)),
            "registers_ds16": regs, "spill_bytes_ds16": spill,
            "worst_of_tolerance": worst})
        print(line, flush=True)
        lines.append(line)
    return lines


def sweep_forward(torch, F, dev):
    """Each VARIANTS build of the forward against the plain version at
    SMALL and PATH, and its time at PATH; returns the JSON lines."""
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(4321)

    def inputs(b, t, d_in, ds):
        u = torch.randn((b, t, d_in), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, t, d_in), generator=gen,
                                    device=dev) - 2)
        bm = torch.randn((b, t, ds), generator=gen, device=dev)
        cm = torch.randn((b, t, ds), generator=gen, device=dev)
        a = -torch.exp(0.3 * torch.randn((d_in, ds), generator=gen,
                                         device=dev))
        dsk = 0.5 + torch.rand(d_in, generator=gen, device=dev)
        return u, dt, bm, cm, a, dsk

    cases = [(shape, inputs(*shape)) for shape in (SMALL, PATH)]
    wants = [ssm_scan_ref(*xs) for _, xs in cases]
    lines = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (spl, chunk, channels), path, regs, spill in build(VARIANTS):
        lib = ctypes.CDLL(str(path))
        fn = lib.repro_ssm_scan
        fn.argtypes, fn.restype = ops._SIGNATURE, ctypes.c_int

        def run(xs):
            b, t, d_in = xs[0].shape
            ds = xs[4].shape[1]
            y = torch.empty((b, t, d_in), device=dev)
            h = torch.empty((b, d_in, ds), device=dev)
            err = fn(*(x.data_ptr() for x in xs), y.data_ptr(),
                     h.data_ptr(), b, t, d_in, ds, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return y, h

        worst = 0.0
        for (_, xs), want in zip(cases, wants):
            for got, ref in zip(run(xs), want):
                worst = max(worst, float(((got - ref).abs()
                                          / (ATOL + RTOL * ref.abs())).max()))
        xs = cases[1][1]
        line = json.dumps({"states_per_lane": spl, "chunk": chunk,
                           "channels": channels,
                           "ms": events_ms(torch, lambda: run(xs)),
                           "registers_ds16": regs, "spill_bytes_ds16": spill,
                           "worst_of_tolerance": worst})
        print(line, flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true",
                    help="sweep the backward kernel's choices instead")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssm_scan_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    if opts.backward:
        lines = sweep_backward(torch, dev)
    else:
        lines = sweep_forward(torch, F, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
