"""The selective scan's backward algorithm (``ref.ssm_scan_bwd_ref``, which
the CUDA kernel ``csrc/ssm_scan_bwd.cu`` follows) against the JAX package
on the CPU; the chunk states the training forward keeps
(``ref.ssm_scan_chunked_ref``); the wiring of ``ops._ScanFn`` by a float64
``gradcheck`` with its two launches replaced by the plain algorithms.

Inputs come from a numpy seed; the JAX side is ``jax.vjp`` of the
reference's ``ssm_scan_ref`` (a ``lax.scan`` over time) with the
cotangents of both y and the final h.

Tolerance: |got - want| <= rtol |want| + atol max|want|, rtol = atol =
1e-5, on each of du, ddt, dB, dC, da, dd_skip: both sides fp32, the sums
over states, channels, time and batch rows taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.ssm_scan import ssm_scan_ref as jssm_scan_ref
from repro_torch import kernels
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (CHUNK, bwd_channel_block,
                                              ssm_scan_bwd_ref,
                                              ssm_scan_chunked_ref,
                                              ssm_scan_ref)
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL = ATOL = 1e-5
NAMES = ("du", "ddt", "dB", "dC", "da", "dd_skip")

# (B, T, d_in, ds, dt scale, dh_final): the reference's SSM_CASES; ragged T
# (off the 16-step chunks, and under one chunk); ds 1 and 64; no final-h
# cotangent; dt large enough that exp(dt a) underflows to 0; d_in over
# three of the kernel's 256-channel dB/dC slabs, the last ragged
CASES = [(2, 64, 128, 16, 1.0, True), (1, 128, 256, 8, 1.0, True),
         (2, 32, 64, 4, 1.0, True), (1, 16, 32, 16, 1.0, True),
         (2, 37, 24, 5, 1.0, True), (1, 9, 16, 16, 1.0, True),
         (1, 33, 16, 1, 1.0, True), (1, 20, 8, 64, 1.0, True),
         (2, 40, 32, 16, 1.0, False), (1, 48, 32, 16, 60.0, True),
         (1, 20, 600, 16, 1.0, True)]


def _inputs(b, t, d_in, ds, dt_scale, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, d_in)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((b, t, d_in)) - 2))
          ).astype(np.float32)
    bm, cm = (rng.standard_normal((b, t, ds)).astype(np.float32)
              for _ in range(2))
    # Jamba's a = -exp(a_log), a_log = log(1..ds), with some spread
    a = -(np.arange(1, ds + 1, dtype=np.float32)[None, :]
          * np.exp(0.3 * rng.standard_normal((d_in, ds)))).astype(np.float32)
    d_skip = rng.standard_normal(d_in).astype(np.float32)
    dy = rng.standard_normal((b, t, d_in)).astype(np.float32)
    dh = rng.standard_normal((b, d_in, ds)).astype(np.float32)
    return (u, dt, bm, cm, a, d_skip), dy, dh


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = RTOL * np.abs(want) + ATOL * max(np.abs(want).max(), 1e-30)
    worst = float((np.abs(got - want) / tol).max())
    assert worst <= 1, f"{what}: {worst:.3g} of the tolerance"


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ssm_scan_bwd_ref_matches_jax_vjp(case):
    b, t, d_in, ds, dt_scale, with_dh = case
    xs, dy, dh = _inputs(b, t, d_in, ds, dt_scale, t + d_in + ds)
    if not with_dh:
        dh = np.zeros_like(dh)
    want = jax.jit(lambda xs, dy, dh: jax.vjp(jssm_scan_ref, *xs)[1](
        (dy, dh)))(tuple(jnp.asarray(x) for x in xs), jnp.asarray(dy),
                   jnp.asarray(dh))
    tx = [torch.from_numpy(x) for x in xs]
    _, _, h_chunks = ssm_scan_chunked_ref(*tx)
    got = ssm_scan_bwd_ref(*tx, h_chunks, torch.from_numpy(dy),
                           torch.from_numpy(dh) if with_dh else None)
    if dt_scale > 1:   # the case exercises the underflow it is named for
        assert float(np.exp(xs[1][..., None] * xs[4]).min()) == 0.0
    for name, g, w, x in zip(NAMES, got, want, xs):
        assert g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w, f"{name} at {case}")


@pytest.mark.parametrize("ds,channels", [(1, 1024), (4, 1024), (5, 512),
                                         (16, 256), (17, 128), (64, 64)])
def test_bwd_channel_block_is_a_clusters_channels(ds, channels):
    """A dB/dC partial covers the 8 blocks of a cluster: 128 threads, a
    channel's states over lanes of 4 (all of a bucket of 4 or less)."""
    assert bwd_channel_block(ds) == channels


def test_chunked_forward_keeps_each_chunks_entering_state():
    """y and h as ``ssm_scan_ref``'s; chunk k's state is h after k CHUNK
    steps (zero for chunk 0), ceil(T / CHUNK) of them."""
    xs, _, _ = _inputs(2, 2 * CHUNK + 5, 12, 6, 1.0, 0)
    tx = [torch.from_numpy(x) for x in xs]
    y, h, h_chunks = ssm_scan_chunked_ref(*tx)
    want_y, want_h = ssm_scan_ref(*tx)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert h_chunks.shape == (2, 3, 12, 6)
    assert not h_chunks[:, 0].any()
    for k in (1, 2):
        _, h_k = ssm_scan_ref(*(x[:, :k * CHUNK] if x.dim() == 3 else x
                                for x in tx))
        assert torch.equal(h_chunks[:, k], h_k)


@pytest.mark.parametrize("t,ds,use", [(21, 3, "both"), (5, 1, "y"),
                                      (18, 4, "h")])
def test_scan_fn_gradcheck_with_plain_launches(monkeypatch, t, ds, use):
    """``_ScanFn`` in float64 with ``_launch`` and ``ssm_scan_bwd``
    replaced by the plain algorithms: the saved chunk states, the
    cotangents of y and of the final h (each alone and both), six input
    gradients."""
    monkeypatch.setattr(ops, "_launch", lambda *xs, chunks:
                        ssm_scan_chunked_ref(*xs))
    monkeypatch.setattr(ops, "ssm_scan_bwd", ssm_scan_bwd_ref)
    xs, _, _ = _inputs(1, t, 3, ds, 1.0, t)
    xs = [torch.from_numpy(x).double().requires_grad_() for x in xs]

    def fn(*inputs):
        y, h = ops._ScanFn.apply(*inputs)
        return {"both": (y, h), "y": y, "h": h}[use]

    assert torch.autograd.gradcheck(fn, xs)


def test_cpu_wrapper_runs_the_plain_version_under_grad():
    """On the CPU ``ssm_scan`` runs the plain version, which autograd
    follows, and launches nothing."""
    kernels.reset_launch_counts()
    xs, _, _ = _inputs(1, 20, 8, 4, 1.0, 5)
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    y, h = ops.ssm_scan(*tx)
    (y.sum() + h.sum()).backward()
    assert all(x.grad is not None for x in tx)
    assert set(kernels.launch_counts().values()) == {0}
