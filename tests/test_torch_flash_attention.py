"""The port's flash attention (``flash_attention`` and the GQA wrapper
``mha``) against the JAX package's Pallas kernel in interpret mode and its
``attention_ref``, on the CPU (the port's plain version).

Tolerance: rtol/atol 3e-5 in fp32 and atol 3e-2 in bf16, as the JAX tests
hold the TPU kernel (``tests/test_kernels.py``): fp32 sums in another
order, and bf16 outputs rounded at other places.

The CUDA kernel runs both products on the tensor cores in 3xTF32; the
last tests hold a CPU emulation of that arithmetic (``ref.attention_tf32``)
to the same fp32 tolerance, and show that a single TF32 pass misses it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_attention import mha as jmha
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_tf32, mha_ref,
                                                     tf32_round)
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL = ATOL = 3e-5
BF16_ATOL = 3e-2

# the reference's FLASH_CASES: b, h, s, d, causal, window, bq, bk
FLASH_CASES = [
    (2, 4, 256, 64, True, 0, 128, 128),
    (1, 2, 128, 32, False, 0, 64, 64),
    (2, 2, 256, 64, True, 64, 64, 128),
    (1, 1, 512, 128, True, 0, 128, 128),
    (1, 2, 128, 16, True, 32, 32, 64),
]


def _qkv(shape, kv_shape=None, seed=0):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or shape
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"b{c[0]}h{c[1]}"
                         f"s{c[2]}d{c[3]}c{int(c[4])}w{c[5]}")
def test_flash_attention_matches_pallas_kernel(case):
    b, h, s, d, causal, window, bq, bk = case
    q, k, v = _qkv((b, h, s, d), seed=s + d)
    want = np.asarray(jflash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True))
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = np.asarray(jattention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_flash_attention_bf16():
    q, k, v = _qkv((1, 2, 128, 64), seed=7)
    want = np.asarray(jflash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        interpret=True), np.float32)
    got = ops.flash_attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_mha_gqa_matches_reference(causal, window):
    b, s, hq, hkv, d = 2, 128, 8, 2, 32
    q, k, v = _qkv((b, s, hq, d), (b, s, hkv, d), seed=9)
    want = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window, block_q=64,
                           block_k=64, use_kernel=True))
    got = ops.mha(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,d,window", [(100, 64, 0), (257, 36, 0),
                                        (130, 112, 48), (33, 256, 0)])
def test_ragged_seq_and_head_dims_match_attention_ref(s, d, window):
    """Shapes the Pallas kernel's BlockSpecs refuse (S not a block
    multiple) and the head dims of minicpm (36) and kimi (112): held to the
    reference's dense oracle."""
    q, k, v = _qkv((1, 3, s, d), seed=s)
    want = np.asarray(jattention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window))
    got = ops.flash_attention(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the GQA wrapper on the same function, with 3 query heads per kv head
    qg, kg, vg = _qkv((1, s, 3, d), (1, s, 1, d), seed=s + 1)
    want = np.asarray(jmha(jnp.asarray(qg), jnp.asarray(kg), jnp.asarray(vg),
                           causal=True, window=window, use_kernel=False))
    got = ops.mha(*_t(qg, kg, vg), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_version_is_the_reference_oracle():
    q, k, v = _qkv((2, 2, 64, 16), seed=3)
    want = np.asarray(jattention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False, window=8))
    got = attention_ref(*_t(q, k, v), causal=False, window=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shape_errors_raise_value_error():
    q, k, v = _t(*_qkv((1, 2, 64, 32)))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :32], v[:, :, :32])
    with pytest.raises(ValueError):       # the reference raises for this too
        jflash_attention(jnp.zeros((1, 2, 64, 32)), jnp.zeros((1, 2, 32, 32)),
                         jnp.zeros((1, 2, 32, 32)))
    with pytest.raises(ValueError):       # head dim not a multiple of 4
        ops.flash_attention(*_t(*_qkv((1, 1, 16, 30))))
    with pytest.raises(ValueError):       # head dim above 256
        ops.flash_attention(*_t(*_qkv((1, 1, 8, 260))))
    with pytest.raises(ValueError):       # 3 query heads over 2 kv heads
        ops.mha(*_t(*_qkv((1, 16, 3, 32), (1, 16, 2, 32))))
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())


def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.flash_attention.launches = 0
    ops.mha(*_t(*_qkv((1, 16, 2, 32), (1, 16, 1, 32))))
    ops.flash_attention(*_t(*_qkv((1, 2, 16, 32))))
    assert ops.flash_attention.launches == 0


def test_tf32_round_is_round_to_nearest_ties_away():
    """``cvt.rna.tf32.f32``: 10 explicit mantissa bits, ties away from 0."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp + ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 4, 1 + 3 * ulp / 4, 3.14159265, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 1 + ulp, 3.140625,
            0.0]
    assert tf32_round(x).tolist() == want


def _emulated_mha(q, k, v, *, causal, window, passes):
    """``mha`` with both products in ``passes`` TF32 passes: [B, S, H, D]
    q and [B, S, Hkv, D] k, v, kv heads repeated as the kernel reads them."""
    rep = q.shape[2] // k.shape[2]
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = attention_tf32(q.transpose(1, 2), kt, vt, causal=causal,
                         window=window, passes=passes)
    return out.transpose(1, 2)


TF32_MASKS = [(True, 0), (True, 32), (False, 0)]


@pytest.mark.parametrize("causal,window", TF32_MASKS,
                         ids=["causal", "window32", "bidirectional"])
@pytest.mark.parametrize("d", [36, 64, 128])
def test_three_pass_tf32_holds_the_fp32_tolerance(d, causal, window):
    """Both products in 3xTF32 (the kernel's arithmetic) against the port's
    plain version and the JAX package's Pallas kernel in interpret mode, at
    rtol/atol 3e-5, with 2 query heads per kv head."""
    b, s, hq, hkv = 1, 128, 4, 2
    q, k, v = _qkv((b, s, hq, d), (b, s, hkv, d), seed=d + window)
    got = _emulated_mha(*_t(q, k, v), causal=causal, window=window, passes=3)
    want = mha_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    rep = hq // hkv
    jq = jnp.asarray(q).transpose(0, 2, 1, 3)
    jk, jv = (jnp.repeat(jnp.asarray(x), rep, axis=2).transpose(0, 2, 1, 3)
              for x in (k, v))
    pallas = np.asarray(jflash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)


def test_one_pass_tf32_misses_the_fp32_tolerance():
    """The gate catches the shortcut: one TF32 pass per product at D 128
    is off the 3e-5 tolerance, by more than 10x at the worst element."""
    q, k, v = _qkv((1, 128, 4, 128), (1, 128, 2, 128), seed=128)
    want = mha_ref(*_t(q, k, v), causal=True).numpy()
    got = _emulated_mha(*_t(q, k, v), causal=True, window=0,
                        passes=1).numpy()
    excess = np.abs(got - want) / (ATOL + RTOL * np.abs(want))
    assert excess.max() > 10
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
