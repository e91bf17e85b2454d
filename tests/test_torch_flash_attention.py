"""The port's flash attention (``flash_attention`` and the GQA wrapper
``mha``) against the JAX package's Pallas kernel in interpret mode and its
``attention_ref``, on the CPU (the port's plain version).

Tolerance: rtol/atol 3e-5 in fp32 and atol 3e-2 in bf16, as the JAX tests
hold the TPU kernel (``tests/test_kernels.py``): fp32 sums in another
order, and bf16 outputs rounded at other places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_attention import mha as jmha
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

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
