#!/usr/bin/env python3
"""Sweep the build-time choices of the selective-scan kernel on one NVIDIA
GPU: states per lane (``REPRO_SSM_STATES_PER_LANE``), time steps per staged
chunk (``REPRO_SSM_CHUNK``) and channels per block (``REPRO_SSM_CHANNELS``)
of ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu``.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/ssm_scan_sweep.py [--out FILE]

Each variant is built with ``nvcc`` (all at once) into
``build/repro_torch/sweep/``, checked against the plain version at a small
case and at the serve path's Mamba shape (B 4, T 2048, d_in 16384, ds 16;
atol 2e-5 + rtol 1e-5), and timed there with CUDA events. Prints one JSON
line per variant (ms, registers, spill bytes, worst share of the
tolerance) and the card's name and power limit.
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


def build(variants):
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for spl, chunk, channels in variants:
        lib = out_dir / f"ssm_scan_spl{spl}_chunk{chunk}_ch{channels}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-DREPRO_SSM_STATES_PER_LANE={spl}",
               f"-DREPRO_SSM_CHUNK={chunk}",
               f"-DREPRO_SSM_CHANNELS={channels}", "-o", str(lib),
               str(_build.SOURCES["ssm_scan"])]
        procs.append(((spl, chunk, channels), lib, subprocess.Popen(
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
            if "ssm_scan_kernelILi16ELb1ELb1E" in line:
                for nxt in lines[i + 1:i + 4]:
                    m = re.search(r"(\d+) bytes spill stores", nxt)
                    spill = int(m.group(1)) if m else spill
                    m = re.search(r"Used (\d+) registers", nxt)
                    regs = int(m.group(1)) if m else regs
        built.append((variant, lib, regs, spill))
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssm_scan_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    dev = torch.device("cuda", 0)
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
        for _ in range(3):
            run(xs)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 20
        start.record()
        for _ in range(reps):
            run(xs)
        end.record()
        end.synchronize()
        line = json.dumps({"states_per_lane": spl, "chunk": chunk,
                           "channels": channels,
                           "ms": start.elapsed_time(end) / reps,
                           "registers_ds16": regs, "spill_bytes_ds16": spill,
                           "worst_of_tolerance": worst})
        print(line, flush=True)
        lines.append(line)
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
