"""Kernel benchmark on the card: each hand-written CUDA kernel of the port
against its plain PyTorch version and, where one PyTorch call computes the
same function, that call (the library column of ``PERF.md``'s kernel
table; timed only, the port never calls it).

Shapes: the JAX package's ``benchmarks/bench_kernels.py`` (attention B 1,
H 4, S 1024, D 64; FedAvg C 20 x 1 M; the PoW race C 8 x 65 536 attempts)
and the main paths' (the paper's four MLP leaves at C = 20, the cohort
path's at C = 64 and 128, the mine stage at 10 240 attempts, Jamba's
attention and Mamba shapes, PaliGemma's attention under its prefix-LM
mask and HuBERT's bidirectional one). Every reading is device ms a call by CUDA
events over back-to-back calls queued behind a spin kernel
(``timing.events_ms``, the helper ``chip_smoke.py`` uses). Prints one CSV
line a case (``name,us_per_call,derived``) and a JSON line with every
reading and the card's name and power limit.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels [--quick]

``--against DIR`` also times ``mix_rows_flat`` at R = K = 20 and 64 over
the paper's leaves, ``flash_attention`` at the four serve paths' shapes
(Jamba's and DeepSeek's causal ones, PaliGemma's prefix-LM form, HuBERT's
bidirectional one) and ``ssm_scan`` at Jamba's, with the kernels built
from another tree's ``src`` (an unpacked parent commit), each held bitwise
to this tree's serving launch, and the two backward kernels,
``flash_attention_bwd`` at phi4-mini's training shape and ``ssm_scan_bwd``
at Jamba's training layer, each held to this tree's within
``chip_smoke.py`` phase 7a's gate; all timed in the order other, this,
this, other, by the profiler and by CUDA events (``timing.kernel_ms``).
The other tree's flash source must take the prefix-LM form's
``prefix_len``.

It needs the card: ``--device cpu`` is refused, since a CPU run times
PyTorch's CPU kernels and not these.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
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
    # (label, shape, causal, prefix)
    for label, (b, h, hkv, s, d), causal, prefix in (
            ("B1_H4_S1024_D64", (1, 4, 4, 1024, 64), True, 0),
            ("jamba_B4_H64_8_S2048_D128", (4, 64, 8, 2048, 128), True, 0),
            ("paligemma_B4_H8_1_S2048_D256_prefix256",
             (4, 8, 1, 2048, 256), True, 256),
            ("hubert_B4_H16_S2048_D80_bidirectional",
             (4, 16, 16, 2048, 80), False, 0)):
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        keep = (flash_ref.keep_mask(s, causal=True, window=0,
                                    prefix_len=prefix, device=dev)
                if prefix else None)
        mask = dict(causal=causal, prefix_len=prefix)
        cases.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, m=mask: flash_ops.mha(q, k, v, **m),
            lambda q=q, k=k, v=v, m=mask: flash_ref.mha_ref(q, k, v, **m),
            lambda q=q, k=k, v=v, c=causal and not prefix, keep=keep:
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=keep, is_causal=c, enable_gqa=True)))
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


def _alternate(fns: dict, label: str, csv_name: str, out: dict, **kw):
    """Time ``fns["other"]`` and ``fns["this"]`` in the order other, this,
    this, other (``timing.kernel_ms`` with ``kw``): each reading into
    ``out`` under ``"<label> <which> <i>"``, and a CSV line."""
    for i, which in enumerate(("other", "this", "this", "other")):
        key = f"{label} {which} {i}"
        timing.kernel_ms(fns[which], key, **kw)
        reading = timing.READINGS[key]
        out[key] = {name: reading[name]
                    for name in ("profiler_ms", "events_ms")}
        common.csv_line(f"kernel_{csv_name}_{which}_{i}",
                        1e3 * reading["profiler_ms"],
                        f"events_us={1e3 * reading['events_ms']:.2f}")


def _flash_of(src_dir: str):
    """``repro_flash_attention`` built from ``src_dir``'s source, as an
    ``mha`` ``(q, k, v, causal, prefix_len) -> out`` on [B, S, H, D]
    contiguous fp32 tensors on the current stream."""
    from repro_torch.kernels import _build

    cu = Path(src_dir) / "repro_torch" / "kernels" / "flash_attention" \
        / "csrc" / "flash_attention.cu"
    fn = _build.load_file(cu, "flash_attention-against").repro_flash_attention
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 4 + [i] * 6 + [ll] * 12 + [ctypes.c_float, i, i, i,
                                                    p]
    fn.restype = ctypes.c_int

    def mha(q, k, v, causal, prefix_len):
        b, s, h, d = q.shape
        out = torch.empty_like(q)
        strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
                 b, h, k.shape[2], s, d, *strides, 1.0 / math.sqrt(d),
                 int(causal), 0, prefix_len,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention of {src_dir}: CUDA error "
                               f"{err}")
        return out

    return mha


def _ssm_scan_of(src_dir: str):
    """``repro_ssm_scan`` built from ``src_dir``'s source, as a function
    ``(u, dt, bmat, cmat, a, d_skip) -> (y, h)`` on contiguous fp32 tensors
    on the current stream."""
    from repro_torch.kernels import _build

    cu = Path(src_dir) / "repro_torch" / "kernels" / "ssm_scan" / "csrc" \
        / "ssm_scan.cu"
    fn = _build.load_file(cu, "ssm_scan-against").repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def scan(u, dt, bmat, cmat, a, d_skip):
        bsz, t, d_in = u.shape
        y = torch.empty_like(u)
        h = torch.empty((bsz, d_in, a.shape[1]), device=u.device)
        err = fn(*(x.data_ptr() for x in (u, dt, bmat, cmat, a, d_skip, y,
                                          h)),
                 bsz, t, d_in, a.shape[1],
                 torch.cuda.current_stream(u.device).cuda_stream)
        if err:
            raise RuntimeError(f"ssm_scan of {src_dir}: CUDA error {err}")
        return y, h

    return scan


# (label, (B, H, Hkv, S, D), causal, prefix_len): the serve paths' shapes
FLASH_SERVE_SHAPES = (("gqa", (4, 64, 8, 2048, 128), True, 0),
                      ("mla", (4, 128, 128, 2048, 192), True, 0),
                      ("vlm prefix", (4, 8, 1, 2048, 256), True, 256),
                      ("audio bidirectional", (4, 16, 16, 2048, 80), False,
                       0))


def compare_flash(against: str, dev) -> dict:
    """``flash_attention`` of this tree against the one of ``against`` at
    the serve paths' shapes and masks (FLASH_SERVE_SHAPES), bitwise equal,
    timed in the order other, this, this, other."""
    from repro_torch.kernels.flash_attention import ops

    other = _flash_of(against)
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for label, (b, h, hkv, s, d), causal, prefix in FLASH_SERVE_SHAPES:
        q = torch.randn((b, s, h, d), generator=gen, device=dev)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                for _ in range(2))
        if not torch.equal(other(q, k, v, causal, prefix),
                           ops.mha(q, k, v, causal=causal,
                                   prefix_len=prefix)):
            raise RuntimeError(f"flash_attention differs from {against}'s "
                               f"at {(b, h, hkv, s, d)} ({label})")
        _alternate({"other": lambda: other(q, k, v, causal, prefix),
                    "this": lambda: ops.mha(q, k, v, causal=causal,
                                            prefix_len=prefix)},
                   f"flash_attention {label}",
                   "flash_attention_" + label.replace(" ", "_"), out,
                   reps=10)
        del q, k, v
    return out


def compare_scan(against: str, dev) -> dict:
    """``ssm_scan`` of this tree against the one of ``against`` at Jamba's
    serve shape (B 4, T 2048, d_in 16 384, ds 16), y and the final state
    bitwise equal, timed in the order other, this, this, other."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan import ops

    other = _ssm_scan_of(against)
    gen = torch.Generator(device=dev).manual_seed(3)
    bsz, t, d_in, ds = 4, 2048, 16384, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u, bm, cm = randn(bsz, t, d_in), randn(bsz, t, ds), randn(bsz, t, ds)
    xs = (u, F.softplus(randn(bsz, t, d_in) - 2), bm, cm,
          -torch.exp(0.3 * randn(d_in, ds)), randn(d_in))
    if not all(torch.equal(a, b) for a, b in zip(other(*xs),
                                                 ops.ssm_scan(*xs))):
        raise RuntimeError(f"ssm_scan differs from {against}'s at "
                           f"{(bsz, t, d_in, ds)}")
    out = {}
    _alternate({"other": lambda: other(*xs),
                "this": lambda: ops.ssm_scan(*xs)},
               "ssm_scan jamba", "ssm_scan_jamba", out, reps=10)
    return out


def _flash_bwd_of(src_dir: str):
    """``repro_flash_attention_bwd`` built from ``src_dir``'s source, as a
    causal ``(q, k, v, o, lse, dout) -> (dq, dk, dv)`` on [B, S, H, D]
    contiguous fp32 tensors on the current stream, with the workspace that
    source asks for (its ``repro_flash_attention_bwd_workspace``, or the
    rows' D alone where it has none)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    cu = Path(src_dir) / "repro_torch" / "kernels" / "flash_attention" \
        / "csrc" / "flash_attention_bwd.cu"
    lib = _build.load_file(cu, "flash_attention_bwd-against")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes, fn.restype = ops._SIGNATURE_BWD, ctypes.c_int
    size = getattr(lib, "repro_flash_attention_bwd_workspace", None)
    if size is not None:
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_longlong

    def bwd(q, k, v, o, lse, dout):
        b, s, h, d = q.shape
        hkv = k.shape[2]
        grads = [torch.empty_like(x) for x in (q, k, v)]
        work = torch.empty(size(b, h, hkv, s, d) if size else b * h * s,
                           device=q.device)
        strides = [st for x in (q, k, v, o, dout, *grads)
                   for st in x.stride()[:3]]
        err = fn(*(x.data_ptr() for x in (q, k, v, o, dout, lse, work,
                                          *grads)),
                 b, h, hkv, s, d, *strides, 1.0 / math.sqrt(d), 1, 0, 0,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd of {src_dir}: CUDA "
                               f"error {err}")
        return grads

    return bwd


def _ssm_scan_bwd_of(src_dir: str):
    """``repro_ssm_scan_bwd`` built from ``src_dir``'s source, as a
    function ``(u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh) -> (du,
    ddt, dB, dC, da, dd_skip)`` on contiguous fp32 tensors on the current
    stream."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops

    cu = Path(src_dir) / "repro_torch" / "kernels" / "ssm_scan" / "csrc" \
        / "ssm_scan_bwd.cu"
    lib = _build.load_file(cu, "ssm_scan_bwd-against")
    fn = lib.repro_ssm_scan_bwd
    fn.argtypes, fn.restype = ops._SIGNATURE_BWD, ctypes.c_int
    size = lib.repro_ssm_scan_bwd_workspace
    size.argtypes, size.restype = [ctypes.c_int] * 4, ctypes.c_longlong

    def bwd(u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh):
        bsz, t, d_in = u.shape
        ds = a.shape[1]
        grads = [torch.empty_like(x) for x in (u, dt, bmat, cmat, a, d_skip)]
        work = torch.empty(size(bsz, t, d_in, ds), device=u.device)
        err = fn(*(x.data_ptr() for x in (u, dt, bmat, cmat, a, d_skip,
                                          h_chunks, dy, dh, *grads, work)),
                 ops.CHUNK, bsz, t, d_in, ds,
                 torch.cuda.current_stream(u.device).cuda_stream)
        if err:
            raise RuntimeError(f"ssm_scan_bwd of {src_dir}: CUDA error "
                               f"{err}")
        return grads

    return bwd


# chip_smoke.py phase 7a's gates on the backward kernels: |a - b| <= rtol
# |b| + atol max|b| on each gradient
FLASH_GRAD_TOL = (1e-4, 1e-4)
SSM_GRAD_TOL = (1e-4, 2e-5)


def _within(got, want, rtol, atol) -> float:
    """Largest |got - want| / (rtol |want| + atol max|want|)."""
    tol = rtol * want.abs() + atol * want.abs().max().clamp_min(1e-30)
    return float(((got - want).abs() / tol).max())


def compare_flash_bwd(against: str, dev) -> dict:
    """``flash_attention_bwd`` of this tree against the one of ``against``
    at phi4-mini's training shape (B 2, H 24, Hkv 8, S 512, D 128, causal)
    on the same forward's O and lse, each gradient within phase 7a's gate
    of the other's (the arithmetic differs, so not bitwise), timed in the
    order other, this, this, other."""
    from repro_torch.kernels.flash_attention import ops

    other = _flash_bwd_of(against)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, h, hkv, s, d = 2, 24, 8, 512, 128
    q = torch.randn((b, s, h, d), generator=gen, device=dev)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
            for _ in range(2))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev)
    mask = dict(seq_axis=1, head_axis=2, causal=True, window=0,
                scale=1.0 / math.sqrt(d), prefix_len=0)
    o, lse = ops._forward_lse(q, k, v, **mask)
    worst = max(_within(a, w, *FLASH_GRAD_TOL) for a, w in zip(
        ops.flash_attention_bwd(q, k, v, o, lse, dout, **mask),
        other(q, k, v, o, lse, dout)))
    if worst > 1:
        raise RuntimeError(f"flash_attention_bwd differs from {against}'s "
                           f"at {(b, h, hkv, s, d)}: {worst:.3g} of the "
                           "gate")
    out = {"flash_attention_bwd phi4 worst_of_gate": worst}
    _alternate({"other": lambda: other(q, k, v, o, lse, dout),
                "this": lambda: ops.flash_attention_bwd(q, k, v, o, lse,
                                                        dout, **mask)},
               "flash_attention_bwd phi4", "flash_attention_bwd_phi4", out,
               reps=10)
    return out


def compare_scan_bwd(against: str, dev) -> dict:
    """``ssm_scan_bwd`` of this tree against the one of ``against`` at
    Jamba's training layer (B 2, T 512, d_in 16 384, ds 16) on the same
    forward's chunk states, each gradient within phase 7a's gate of the
    other's, timed in the order other, this, this, other."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan import ops

    other = _ssm_scan_bwd_of(against)
    gen = torch.Generator(device=dev).manual_seed(5)
    bsz, t, d_in, ds = 2, 512, 16384, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    xs = (randn(bsz, t, d_in), F.softplus(randn(bsz, t, d_in) - 2),
          randn(bsz, t, ds), randn(bsz, t, ds),
          -torch.exp(0.3 * randn(d_in, ds)), randn(d_in))
    dy, dh = randn(bsz, t, d_in), randn(bsz, d_in, ds)
    _, _, h_chunks = ops._launch(*xs, chunks=True)
    worst = max(_within(a, w, *SSM_GRAD_TOL) for a, w in zip(
        ops.ssm_scan_bwd(*xs, h_chunks, dy, dh),
        other(*xs, h_chunks, dy, dh)))
    if worst > 1:
        raise RuntimeError(f"ssm_scan_bwd differs from {against}'s at "
                           f"{(bsz, t, d_in, ds)}: {worst:.3g} of the gate")
    out = {"ssm_scan_bwd jamba worst_of_gate": worst}
    _alternate({"other": lambda: other(*xs, h_chunks, dy, dh),
                "this": lambda: ops.ssm_scan_bwd(*xs, h_chunks, dy, dh)},
               "ssm_scan_bwd jamba", "ssm_scan_bwd_jamba", out, reps=10)
    return out


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
        _alternate({"other": lambda: [other(w, x) for x in xs],
                    "this": lambda: [ops.mix_rows_flat(w, x) for x in xs]},
                   f"mix_rows_flat R{r}xK{r}_leaves", f"mix_rows_flat_R{r}",
                   out)
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
    ``against`` adds :func:`compare_mix`, :func:`compare_flash`,
    :func:`compare_scan`, :func:`compare_flash_bwd` and
    :func:`compare_scan_bwd` with that tree."""
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
        out["against"] = {**compare_mix(against, dev),
                          **compare_flash(against, dev),
                          **compare_scan(against, dev),
                          **compare_flash_bwd(against, dev),
                          **compare_scan_bwd(against, dev)}
    out["device"] = card_name()
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the FL kernels only")
    ap.add_argument("--against", metavar="SRC", default=None,
                    help="also compare mix_rows_flat, flash_attention, "
                         "ssm_scan and the two backward kernels with those "
                         "of another tree's src directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu is refused")
    args = ap.parse_args(argv)
    return bench(args.device, args.quick, args.against)


if __name__ == "__main__":
    main()
