"""The port's selective scan and Mamba block against the JAX package's, on
the CPU (the port's plain version).

The kernel cases hold to atol 2e-5, as the JAX tests hold the TPU kernel
(``tests/test_kernels.py``). The block runs the reference with
``REPRO_SSM_KERNEL`` at 0 (its ``lax.scan``) and at 1 (its Pallas kernel in
interpret mode) and the port's ``ssm_scan`` either way; it holds to rtol /
atol 1e-5 (the same fp32 ops, matmuls summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_arch as jget_smoke_arch
from repro.kernels.ssm_scan import ssm_scan as jssm_scan
from repro.kernels.ssm_scan import ssm_scan_ref as jssm_scan_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_arch
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_exp2,
                                              ssm_scan_ref, state_bucket)
from repro_torch.models import ssm
from repro_torch.weights import lm_params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ATOL = 2e-5
BLOCK_RTOL = BLOCK_ATOL = 1e-5

# the reference's SSM_CASES: B, T, d_in, ds, tile_t, tile_d
SSM_CASES = [(2, 64, 128, 16, 16, 64), (1, 128, 256, 8, 32, 128),
             (2, 32, 64, 4, 32, 32), (1, 16, 32, 16, 16, 32)]


def _inputs(b, t, d_in, ds, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, t, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, d_in)) - 2)).astype(np.float32)
    bm = rng.normal(size=(b, t, ds)).astype(np.float32)
    cm = rng.normal(size=(b, t, ds)).astype(np.float32)
    a = (-np.exp(rng.normal(size=(d_in, ds)) * 0.3)).astype(np.float32)
    d = rng.uniform(0.5, 1.5, size=(d_in,)).astype(np.float32)
    return u, dt, bm, cm, a, d


@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: f"B{c[0]}T{c[1]}d{c[2]}s{c[3]}")
def test_ssm_scan_matches_pallas_kernel(case):
    b, t, d_in, ds, tt, td = case
    xs = _inputs(b, t, d_in, ds, seed=t + d_in)
    y_k, h_k = jssm_scan(*(jnp.asarray(x) for x in xs), tile_t=tt,
                         tile_d=td, interpret=True)
    y_r, h_r = jssm_scan_ref(*(jnp.asarray(x) for x in xs))
    y, h = ops.ssm_scan(*(torch.from_numpy(x) for x in xs))
    assert y.shape == (b, t, d_in) and h.shape == (b, d_in, ds)
    for got, want in ((y, y_k), (h, h_k), (y, y_r), (h, h_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 37, 100, 16), (1, 5, 130, 3)])
def test_ragged_shapes_match_reference_oracle(shape):
    """T and d_in the Pallas kernel's tiles do not divide, and a d_state
    below the kernel's smallest bucket: held to the reference's lax.scan."""
    xs = _inputs(*shape, seed=sum(shape))
    y_r, h_r = jssm_scan_ref(*(jnp.asarray(x) for x in xs))
    y, h = ssm_scan_ref(*(torch.from_numpy(x) for x in xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=ATOL)


def test_ssm_scan_rejects_bad_shapes():
    u, dt, bm, cm, a, d = (torch.from_numpy(x)
                           for x in _inputs(1, 8, 16, 4, seed=0))
    with pytest.raises(ValueError):
        ops.ssm_scan(u, dt[:, :4], bm, cm, a, d)
    with pytest.raises(ValueError):
        ops.ssm_scan(u, dt, bm[..., :2], cm, a, d)
    wide = torch.zeros((16, 65))
    with pytest.raises(ValueError):      # d_state above the kernel's 64
        ops.ssm_scan(u, dt, torch.zeros((1, 8, 65)), torch.zeros((1, 8, 65)),
                     wide, d)



# the CUDA kernel's arithmetic (ref.ssm_scan_exp2) at the reference's cases
# and at ds on either side of the kernel's state buckets (1, 5, 9, 17, 33)
# and ragged d_in (130: not a multiple of the kernel's 64-channel blocks or
# of 4): B, T, d_in, ds, tile_t, tile_d
EXP2_CASES = SSM_CASES + [(1, 16, 32, 1, 16, 32), (1, 16, 32, 5, 16, 32),
                          (2, 32, 130, 9, 32, 130), (1, 24, 64, 17, 24, 64),
                          (1, 16, 32, 33, 16, 32), (1, 8, 48, 64, 8, 48)]


@pytest.mark.parametrize("case", EXP2_CASES,
                         ids=lambda c: f"B{c[0]}T{c[1]}d{c[2]}s{c[3]}")
def test_kernel_arithmetic_matches_reference_and_pallas_kernel(case):
    """exp2 of a prescaled a and the kernel's summation order, held to the
    plain version and to the JAX package's kernel (interpret mode) and
    oracle at the kernel's tolerance."""
    b, t, d_in, ds, tt, td = case
    xs = _inputs(b, t, d_in, ds, seed=7 * t + d_in + ds)
    y_k, h_k = jssm_scan(*(jnp.asarray(x) for x in xs), tile_t=tt,
                         tile_d=td, interpret=True)
    y_r, h_r = jssm_scan_ref(*(jnp.asarray(x) for x in xs))
    y_p, h_p = ssm_scan_ref(*(torch.from_numpy(x) for x in xs))
    y, h = ssm_scan_exp2(*(torch.from_numpy(x) for x in xs))
    assert y.shape == (b, t, d_in) and h.shape == (b, d_in, ds)
    for got, want in ((y, y_p), (h, h_p), (y, y_k), (h, h_k), (y, y_r),
                      (h, h_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_state_buckets_cover_every_taken_width():
    assert [state_bucket(ds) for ds in (1, 4, 5, 8, 9, 16, 17, 32, 33, 64)] \
        == [4, 4, 8, 8, 16, 16, 32, 32, 64, 64]
    with pytest.raises(ValueError):
        state_bucket(ops.MAX_D_STATE + 1)


@pytest.mark.parametrize("ds", [1, 64, 65])
def test_wrapper_takes_ds_1_to_64(ds):
    xs = [torch.from_numpy(x) for x in _inputs(1, 6, 8, ds, seed=ds)]
    if ds > ops.MAX_D_STATE:
        with pytest.raises(ValueError, match="ds"):
            ops.ssm_scan(*xs)
        return
    y, h = ops.ssm_scan(*xs)
    y_r, h_r = ssm_scan_ref(*xs)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)


def _jamba_smoke():
    """Jamba's smoke config with MoE off on both sides (the MoE MLP is not
    ported; the Mamba mixer is what these tests hold)."""
    return (dataclasses.replace(jget_smoke_arch("jamba-1.5-large-398b"),
                                moe=None),
            dataclasses.replace(get_smoke_arch("jamba-1.5-large-398b"),
                                moe=None))


@pytest.mark.parametrize("kernel_flag", ["0", "1"])
def test_ssm_forward_and_decode_match_reference(kernel_flag, monkeypatch):
    monkeypatch.setenv("REPRO_SSM_KERNEL", kernel_flag)
    jcfg, cfg = _jamba_smoke()
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       "name": cfg.name}
    key = jax.random.key(0)
    jparams = jssm.init_ssm(key, jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)) \
        .astype(np.float32)
    jy, jst = jssm.ssm_forward(jparams, jcfg, jnp.asarray(x))
    y, st = ssm.ssm_forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(jst[name]),
                                   rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    # three decode steps continue from the forward's final state
    xt = np.random.default_rng(2).normal(size=(3, 2, cfg.d_model)) \
        .astype(np.float32)
    for i in range(3):
        jout, jst = jssm.ssm_decode(jparams, jcfg, jnp.asarray(xt[i]), jst)
        out, st = ssm.ssm_decode(params, cfg, torch.from_numpy(xt[i]), st)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]),
                               rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


def test_ssm_forward_uses_the_scan_wrapper(monkeypatch):
    """Every Mamba forward goes through ``ops.ssm_scan`` (no switch)."""
    calls = []
    real = ops.ssm_scan
    monkeypatch.setattr(ssm.ssm_ops, "ssm_scan",
                        lambda *a: calls.append(1) or real(*a))
    cfg = get_smoke_arch("jamba-1.5-large-398b")
    params = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    ssm.ssm_forward(params, cfg, torch.zeros((1, 4, cfg.d_model)))
    assert calls == [1]
