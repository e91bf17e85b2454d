"""The flash backward's algorithm (``ref.attention_bwd_ref``, which the
CUDA kernel ``csrc/flash_attention_bwd.cu`` follows), the CPU twin of the
kernel's 3xTF32 tensor-core arithmetic (``ref.attention_bwd_tf32``) and
the forward's row logsumexp (``ref.attention_lse_ref``) against the JAX
package on the CPU; the wiring of ``ops._FlashFn`` by a float64
``gradcheck`` with its two launches replaced by the plain algorithms.

Inputs come from a numpy seed. The JAX side is ``jax.vjp`` of the
reference's ``attention_ref`` (kv repeated to H heads inside the
function for GQA, so its cotangent sums the group), and of the JAX
model's ``_sdpa`` under ``build_mask`` for the prefix-LM mask, which
``attention_ref`` lacks.

Tolerance: |got - want| <= rtol |want| + atol max|want|, rtol = atol =
1e-5, on each of dq, dk, dv: both sides fp32, the sums over keys, rows and
a GQA group taken in another order. The lse is held at the same
tolerance against ``jax.nn.logsumexp`` of the masked logits. The 3xTF32
twin is held at the card's gate for the kernel (``chip_smoke.py`` phase
7a): rtol = atol = 1e-4, each product's operands carrying about 22 bits.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.models import attention as jattention
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_bwd_tf32,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     attention_tf32, keep_mask)
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL = ATOL = 1e-5

# the reference's FLASH_CASES (tests/test_kernels.py): b, h, s, d, causal,
# window; kv at H heads
FLASH_CASES = [(2, 4, 256, 64, True, 0), (1, 2, 128, 32, False, 0),
               (2, 2, 256, 64, True, 64), (1, 1, 512, 128, True, 0),
               (1, 2, 128, 16, True, 32)]
# b, h, hkv, s, d, causal, window: GQA, MQA, a window under GQA, ragged S
# (off the kernel's 32-row tiles), bidirectional and ragged, and the zoo's
# head dims minicpm 36, hubert 80 (bidirectional), MLA's 192
EXTRA_CASES = [(2, 4, 2, 64, 32, True, 0), (1, 8, 1, 48, 16, True, 0),
               (1, 4, 2, 96, 16, True, 24), (2, 2, 1, 100, 16, True, 0),
               (1, 2, 2, 37, 8, False, 0), (1, 4, 2, 40, 36, True, 0),
               (1, 2, 2, 48, 80, False, 0), (1, 2, 1, 40, 192, True, 0)]
# b, h, hkv, s, d, prefix: the VLM's prefix-LM mask (prefix 1 is the
# causal mask; prefix S the whole square)
PREFIX_CASES = [(1, 2, 1, 160, 16, 1), (1, 4, 2, 160, 16, 100),
                (1, 2, 2, 160, 16, 160)]
# b, h, hkv, s, d, causal, window, prefix: the 3xTF32 twin under GQA
# (causal, off the kernel's 64-key and 32-row tiles), a window, the
# prefix-LM mask, minicpm's D 36 (padded to the mma depth 8 in the
# kernel), HuBERT's bidirectional D 80, MLA's D 192 under MQA (its dK/dV
# columns split over two blocks)
TF32_CASES = [(2, 4, 2, 100, 32, True, 0, 0), (1, 2, 2, 96, 16, True, 24, 0),
              (1, 4, 2, 160, 16, True, 0, 100), (1, 4, 2, 72, 36, True, 0, 0),
              (1, 2, 2, 48, 80, False, 0, 0), (1, 2, 1, 40, 192, True, 0, 0)]
TF32_RTOL = TF32_ATOL = 1e-4


def _inputs(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, do


def _worst(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol * np.abs(want).max()
    return float((np.abs(got - want) / tol).max())


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    worst = _worst(got, want, rtol, atol)
    assert worst <= 1, f"{what}: {worst:.3g} of the tolerance"


def _port_grads(q, k, v, do, *, causal, window, prefix=0):
    """attention_bwd_ref on the port's plain forward output and lse."""
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    rep = q.shape[1] // k.shape[1]
    o = attention_ref(qt, kt.repeat_interleave(rep, 1),
                      vt.repeat_interleave(rep, 1), causal=causal,
                      window=window, prefix_len=prefix)
    lse = attention_lse_ref(qt, kt, causal=causal, window=window,
                            prefix_len=prefix)
    return attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=causal,
                             window=window, prefix_len=prefix)


def _check(case, seed, jfn, causal, window, prefix=0):
    b, h, hkv, s, d = case
    q, k, v, do = _inputs(b, h, hkv, s, d, seed)
    want = jax.jit(lambda q, k, v, do: jax.vjp(jfn, q, k, v)[1](do))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    got = _port_grads(q, k, v, do, causal=causal, window=window,
                      prefix=prefix)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, f"{name} at {case}")


def _jax_attention(rep, causal, window):
    def fn(q, k, v):
        return jattention_ref(q, jnp.repeat(k, rep, axis=1),
                              jnp.repeat(v, rep, axis=1), causal=causal,
                              window=window)
    return fn


@pytest.mark.parametrize("case", FLASH_CASES + EXTRA_CASES, ids=str)
def test_attention_bwd_ref_matches_jax_vjp(case):
    if len(case) == 6:   # a reference case: kv at H heads
        b, h, s, d, causal, window = case
        hkv = h
    else:
        b, h, hkv, s, d, causal, window = case
    _check((b, h, hkv, s, d), s + d, _jax_attention(h // hkv, causal, window),
           causal, window)


def _jax_prefix_attention(rep, s, d, prefix):
    """The JAX model's ``_sdpa`` under its ``build_mask`` (heads moved to
    its [B, S, H, D] layout and back)."""
    mask = jattention.build_mask(s, causal=True, prefix_len=prefix)

    def fn(q, k, v):
        out = jattention._sdpa(
            q.transpose(0, 2, 1, 3),
            jnp.repeat(k, rep, axis=1).transpose(0, 2, 1, 3),
            jnp.repeat(v, rep, axis=1).transpose(0, 2, 1, 3), mask,
            1.0 / math.sqrt(d))
        return out.transpose(0, 2, 1, 3)
    return fn


@pytest.mark.parametrize("case", PREFIX_CASES, ids=str)
def test_attention_bwd_ref_matches_jax_vjp_under_a_prefix(case):
    """The prefix-LM mask against the JAX model's ``_sdpa`` under its
    ``build_mask``."""
    b, h, hkv, s, d, prefix = case
    _check((b, h, hkv, s, d), prefix,
           _jax_prefix_attention(h // hkv, s, d, prefix), True, 0, prefix)


def _tf32_grads(case, passes):
    """(the 3xTF32 twin's dq, dk, dv with ``passes``, jax.vjp's) at
    ``case``: the twin on the forward's own arithmetic (``attention_tf32``
    for O, ``attention_lse_ref`` for lse), as the kernel gets them."""
    b, h, hkv, s, d, causal, window, prefix = case
    q, k, v, do = _inputs(b, h, hkv, s, d, s + d + prefix)
    rep = h // hkv
    jfn = (_jax_prefix_attention(rep, s, d, prefix) if prefix
           else _jax_attention(rep, causal, window))
    want = jax.jit(lambda q, k, v, do: jax.vjp(jfn, q, k, v)[1](do))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    mask = dict(causal=causal, window=window, prefix_len=prefix)
    o = attention_tf32(qt, kt.repeat_interleave(rep, 1),
                       vt.repeat_interleave(rep, 1), **mask)
    lse = attention_lse_ref(qt, kt, **mask)
    got = attention_bwd_tf32(qt, kt, vt, o, lse, dot, passes=passes, **mask)
    return got, want


@pytest.mark.parametrize("case", TF32_CASES, ids=str)
def test_attention_bwd_tf32_matches_jax_vjp(case):
    """The kernel's 3xTF32 arithmetic holds the card's gradient gate."""
    got, want = _tf32_grads(case, 3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _close(g.numpy(), w, f"{name} at {case}", TF32_RTOL, TF32_ATOL)


def test_attention_bwd_one_tf32_pass_misses_the_gate():
    """One TF32 pass a product (10 bits of each operand) misses the gate
    the kernel's three passes hold: the split is what carries fp32."""
    got, want = _tf32_grads(TF32_CASES[0], 1)
    worst = max(_worst(g.numpy(), w, TF32_RTOL, TF32_ATOL)
                for g, w in zip(got, want))
    assert worst > 2, worst


@pytest.mark.parametrize("causal,window,prefix", [
    (True, 0, 0), (False, 0, 0), (True, 24, 0), (True, 0, 50)])
def test_attention_lse_ref_matches_jax_logsumexp(causal, window, prefix):
    b, h, hkv, s, d = 2, 4, 2, 70, 16
    q, k, _, _ = _inputs(b, h, hkv, s, d, 7)
    logits = np.einsum("bhsd,bhtd->bhst", q,
                       np.repeat(k, h // hkv, axis=1)) / math.sqrt(d)
    ok = keep_mask(s, causal=causal, window=window, prefix_len=prefix,
                   device="cpu").numpy()
    want = jax.nn.logsumexp(jnp.asarray(np.where(ok, logits, -1e30)),
                            axis=-1)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window, prefix_len=prefix)
    _close(got.numpy(), want, "lse")


def _plain_forward(q, k, v, *, seq_axis, head_axis, causal, window, scale,
                   prefix_len):
    """``ops._forward_lse`` in plain float64 torch: (out, lse) in the
    layout (batch, seq_axis, head_axis, dim)."""
    def heads_first(x):
        return x if seq_axis == 2 else x.transpose(1, 2)

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    rep = qh.shape[1] // kh.shape[1]
    logits = torch.einsum("bhsd,bhtd->bhst", qh,
                          kh.repeat_interleave(rep, 1)) * scale
    ok = keep_mask(qh.shape[2], causal=causal, window=window,
                   prefix_len=prefix_len, device=q.device)
    logits = torch.where(ok, logits, -1e30)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1),
                       vh.repeat_interleave(rep, 1))
    return heads_first(out), torch.logsumexp(logits, -1)


def _plain_backward(q, k, v, o, lse, dout, *, seq_axis, head_axis, causal,
                    window, scale, prefix_len):
    def heads_first(x):
        return x if seq_axis == 2 else x.transpose(1, 2)

    grads = attention_bwd_ref(*(heads_first(x) for x in (q, k, v, o)), lse,
                              heads_first(dout), causal=causal,
                              window=window, scale=scale,
                              prefix_len=prefix_len)
    return tuple(heads_first(g) for g in grads)


@pytest.mark.parametrize("layout,hkv,causal,window,prefix", [
    ("bhsd", 3, True, 0, 0), ("bshd", 1, True, 0, 0),
    ("bshd", 3, False, 0, 0), ("bshd", 1, True, 3, 0),
    ("bshd", 1, True, 0, 4)])
def test_flash_fn_gradcheck_with_plain_launches(monkeypatch, layout, hkv,
                                                causal, window, prefix):
    """``_FlashFn`` in float64 with ``_forward_lse`` and
    ``flash_attention_bwd`` replaced by the plain algorithms: saved
    tensors, both layouts (GQA through the [B, S, H, D] one, dk and dv at
    Hkv heads), the mask keywords, None for the non-tensors."""
    monkeypatch.setattr(ops, "_forward_lse", _plain_forward)
    monkeypatch.setattr(ops, "flash_attention_bwd", _plain_backward)
    rng = np.random.default_rng(11)
    b, h, s, d = 1, 3, 7, 4
    seq_axis, head_axis = (2, 1) if layout == "bhsd" else (1, 2)

    def shaped(heads):
        shape = (b, heads, s, d) if layout == "bhsd" else (b, s, heads, d)
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    q, k, v = shaped(h), shaped(hkv), shaped(hkv)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops._FlashFn.apply(q, k, v, seq_axis, head_axis,
                                           causal, window, 0.5, prefix),
        (q, k, v))


def test_cpu_wrappers_run_the_plain_version_under_grad():
    """On the CPU both wrappers run the plain version, which autograd
    follows, and launch nothing; a bf16 input under grad is refused only
    on the path to the backward kernel (``_under_grad``)."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = ops.mha(q, k, v, causal=True)
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    assert set(kernels.launch_counts().values()) == {0}
    bf = q.detach().to(torch.bfloat16).requires_grad_()
    with pytest.raises(TypeError, match="fp32"):
        ops._under_grad("mha", bf, bf, bf)
    assert not ops._under_grad("mha", q.detach(), k.detach(), v.detach())
    with torch.no_grad():
        assert not ops._under_grad("mha", q, k, v)
    assert ops._under_grad("mha", q, k, v)
