"""Kernel benchmark on the card: each hand-written CUDA kernel of the port
against its plain PyTorch version and, where one PyTorch call computes the
same function, that call (the library column of ``PERF.md``'s kernel
table; timed only, the port never calls it).

Shapes: the JAX package's ``benchmarks/bench_kernels.py`` (attention B 1,
H 4, S 1024, D 64; FedAvg C 20 x 1 M; the PoW race C 8 x 65 536 attempts)
and the main paths' (the paper's four MLP leaves at C = 20, the cohort
path's at C = 64 and 128, the mine stage at 10 240 attempts, Jamba's
attention and Mamba shapes). Every reading is device ms a call by CUDA
events over back-to-back calls queued behind a spin kernel
(``timing.events_ms``, the helper ``chip_smoke.py`` uses). Prints one CSV
line a case (``name,us_per_call,derived``) and a JSON line with every
reading and the card's name and power limit.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels [--quick]

``--against DIR`` also times ``mix_rows_flat`` at R = K = 20 and 64 over
the paper's leaves with the kernel built from another tree's ``src`` (an
unpacked parent commit), in the order other, this, this, other, each by
the profiler and by CUDA events (``timing.kernel_ms``).

It needs the card: ``--device cpu`` is refused, since a CPU run times
PyTorch's CPU kernels and not these.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path
from typing import Optional

import torch

from repro_torch.benchmarks import common, timing
from repro_torch.device import resolve_device

LEAF_WIDTHS = (784 * 256, 256, 256 * 10, 10)   # w1, b1, w2, b2


def _fl_cases(dev, gen):
    """(kernel, shape label, fn, plain, library) of the FL kernels."""
    from repro_torch.kernels.fedavg import ops, ref

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = []
    for label, c, widths in (("C20x1M", 20, (1_000_000,)),
                             ("C20_leaves", 20, LEAF_WIDTHS),
                             ("C64_leaves", 64, LEAF_WIDTHS)):
        xs = [randn(c, n) for n in widths]
        u = torch.full((c,), 1.0 / c, device=dev)
        mean_rows = u.expand(c, c).contiguous()
        cases.append(("fedavg_flat", label,
                      lambda xs=xs, u=u: [ops.fedavg_flat(x, u) for x in xs],
                      lambda xs=xs, u=u: [ref.fedavg_flat_ref(x, u)
                                          for x in xs],
                      lambda xs=xs, w=mean_rows: [torch.mm(w, x)
                                                  for x in xs]))
        if len(widths) > 1:
            cases.append(("digest_div_flat", label,
                          lambda xs=xs: [ops.digest_div_flat(x) for x in xs],
                          lambda xs=xs: [ref.digest_div_flat_ref(x)
                                         for x in xs], None))
    for r in (20, 64, 128):
        xs = [randn(r, n) for n in LEAF_WIDTHS]
        w = torch.rand((r, r), generator=gen, device=dev) + 0.1
        w = w / w.sum(dim=1, keepdim=True)
        cases.append(("mix_rows_flat", f"R{r}xK{r}_leaves",
                      lambda xs=xs, w=w: [ops.mix_rows_flat(w, x)
                                          for x in xs],
                      lambda xs=xs, w=w: [ref.mix_rows_flat_ref(w, x)
                                          for x in xs],
                      lambda xs=xs, w=w: [torch.mm(w, x) for x in xs]))
    return cases


def _pow_cases(dev):
    from repro_torch.core import mining
    from repro_torch.kernels.pow_hash import ops, ref

    def word(v):
        return torch.full((), int(v) & mining.MASK, dtype=torch.int64,
                          device=dev)

    prev, digest, off = word(0x1234567), word(0x89ABCDE), word(5 << 20)
    cases = []
    for c in (20, 64):
        cases.append(("pow_race", f"seal_C{c}x10240",
                      lambda c=c: ops.mine_seal(prev, digest, c, 10240,
                                                nonce_offset=off,
                                                difficulty_bits=4),
                      lambda c=c: ref.mine_seal_ref(prev, digest, off, c,
                                                    10240, 4), None))
    payloads = torch.arange(8, dtype=torch.int64, device=dev) * 0x9E3779B1 \
        & mining.MASK
    cases.append(("pow_race", "flat_C8x65536",
                  lambda: ops.pow_race_flat(prev, payloads, off, 65536),
                  lambda: ref.pow_race_ref(prev, off, payloads, 65536),
                  None))
    return cases


def _lm_cases(dev, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = []
    for label, (b, h, hkv, s, d) in (("B1_H4_S1024_D64", (1, 4, 4, 1024, 64)),
                                     ("jamba_B4_H64_8_S2048_D128",
                                      (4, 64, 8, 2048, 128))):
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v: flash_ops.mha(q, k, v, causal=True),
            lambda q=q, k=k, v=v: flash_ref.mha_ref(q, k, v, causal=True),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)))
    bsz, t, d_in, ds = 4, 2048, 16384, 16
    u, bm, cm = randn(bsz, t, d_in), randn(bsz, t, ds), randn(bsz, t, ds)
    dt = F.softplus(randn(bsz, t, d_in) - 2)
    a = -torch.exp(0.3 * randn(d_in, ds))
    dsk = torch.ones(d_in, device=dev)
    cases.append(("ssm_scan", "jamba_B4_T2048_D16384_S16",
                  lambda: ssm_ops.ssm_scan(u, dt, bm, cm, a, dsk),
                  lambda: ssm_ref.ssm_scan_ref(u, dt, bm, cm, a, dsk),
                  None))
    return cases


def _mix_rows_of(src_dir: str):
    """``repro_mix_rows`` built from ``src_dir``'s fedavg.cu
    (``_build.load_file``), as a function ``(w, x) -> out`` on the
    current stream."""
    from repro_torch.kernels import _build

    cu = Path(src_dir) / "repro_torch" / "kernels" / "fedavg" / "csrc" \
        / "fedavg.cu"
    fn = _build.load_file(cu, "fedavg-against").repro_mix_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def mix(w, x):
        out = torch.empty((w.shape[0], x.shape[1]), device=x.device)
        err = fn(w.data_ptr(), x.data_ptr(), out.data_ptr(), w.shape[0],
                 x.shape[0], x.shape[1],
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"mix_rows_flat of {src_dir}: CUDA error "
                               f"{err}")
        return out

    return mix


def compare_mix(against: str, dev) -> dict:
    """``mix_rows_flat`` of this tree against the one of ``against`` at R
    = K = 20 and 64 over the paper's leaves, bitwise equal, timed in the
    order other, this, this, other."""
    from repro_torch.kernels.fedavg import ops

    other = _mix_rows_of(against)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for r in (20, 64):
        xs = [torch.randn((r, n), generator=gen, device=dev)
              for n in LEAF_WIDTHS]
        w = torch.rand((r, r), generator=gen, device=dev) + 0.1
        w = w / w.sum(dim=1, keepdim=True)
        if not all(torch.equal(other(w, x), ops.mix_rows_flat(w, x))
                   for x in xs):
            raise RuntimeError(f"mix_rows_flat differs from {against}'s at "
                               f"R = K = {r}")
        fns = {"other": lambda: [other(w, x) for x in xs],
               "this": lambda: [ops.mix_rows_flat(w, x) for x in xs]}
        for i, which in enumerate(("other", "this", "this", "other")):
            label = f"mix_rows_flat R{r}xK{r}_leaves {which} {i}"
            timing.kernel_ms(fns[which], label)
            reading = timing.READINGS[label]
            out[label] = {key: reading[key]
                          for key in ("profiler_ms", "events_ms")}
            common.csv_line(f"kernel_mix_rows_flat_R{r}_{which}_{i}",
                            1e3 * reading["profiler_ms"],
                            f"events_us={1e3 * reading['events_ms']:.2f}")
    return out


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench(device="cuda", quick: bool = False,
          against: Optional[str] = None) -> dict:
    """Time every case; ``quick`` leaves out the serve path's kernels;
    ``against`` adds :func:`compare_mix` with that tree."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"bench_kernels times the CUDA kernels on the "
                         f"card; device={str(dev)!r} has none of them (the "
                         "CPU runs their plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = _fl_cases(dev, gen) + _pow_cases(dev)
    if not quick:
        cases += _lm_cases(dev, gen)
    out = {}
    for name, label, fn, plain, library in cases:
        big = name in ("flash_attention", "ssm_scan")
        reps = 5 if big else 20
        row = {"ms": timing.events_ms(fn, reps)[0],
               "plain_ms": timing.events_ms(plain, 2 if big else 5, 1)[0],
               "library_ms": (None if library is None
                              else timing.events_ms(library, reps)[0])}
        out[f"{name}|{label}"] = row
        lib = ("none" if row["library_ms"] is None
               else f"{1e3 * row['library_ms']:.2f}")
        common.csv_line(f"kernel_{name}_{label}", 1e3 * row["ms"],
                        f"plain_us={1e3 * row['plain_ms']:.2f};"
                        f"library_us={lib}")
    if against:
        out["against"] = compare_mix(against, dev)
    out["device"] = card_name()
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the FL kernels only")
    ap.add_argument("--against", metavar="SRC", default=None,
                    help="also compare mix_rows_flat with the one of "
                         "another tree's src directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu is refused")
    args = ap.parse_args(argv)
    return bench(args.device, args.quick, args.against)


if __name__ == "__main__":
    main()
