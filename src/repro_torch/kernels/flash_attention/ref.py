"""Plain PyTorch versions of the flash-attention kernel: the CPU paths of
``ops.flash_attention`` (``attention_ref``, the JAX package's
``kernels/flash_attention/ref.py``) and ``ops.mha`` (``mha_ref``), and the
oracles the CUDA kernel is held to."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
# log2(e): the kernels take exp(x) as exp2(x log2(e))
LOG2E = 1.4426950408889634


def keep_mask(s: int, *, causal: bool, window: int, prefix_len: int,
              device) -> torch.Tensor:
    """[S, S] bool, True where row i may attend to key j: under ``causal``
    the keys j <= i, and (prefix-LM) every pair inside the first
    ``prefix_len`` positions, as the JAX package's ``build_mask`` has it;
    without ``causal`` every pair (``prefix_len`` ignored, as there). Then,
    with ``window > 0``, only the keys j > i - window."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        ok = j <= i
        if prefix_len > 0:
            ok = ok | ((i < prefix_len) & (j < prefix_len))
    if window > 0:
        ok = ok & (j > i - window)
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D]; full softmax attention with
    the dense [S, S] mask (``keep_mask``), in fp32, output in q's dtype."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    ok = keep_mask(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device)
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs,
                        v.to(torch.float32)).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            prefix_len: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, Hkv, D] -> [B, S, H, D]: the JAX
    package's ``mha`` without its kernel (kv repeated to H heads, heads
    moved before S, ``attention_ref``, moved back)."""
    rep = q.shape[2] // k.shape[2]
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                        window=window, prefix_len=prefix_len)
    return out.transpose(1, 2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 explicit mantissa bits, ties away from zero (the
    13 low bits of the fp32 word cleared after adding half their unit to
    the magnitude). For finite inputs."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """``a @ b`` with both operands rounded to TF32 as the flash kernel's
    tensor-core products see them. ``passes=3`` splits each operand into
    hi = tf32(x) and lo = tf32(x - hi) and sums lo*hi + hi*lo, then hi*hi
    (lo*lo dropped); ``passes=1`` is a single TF32 product. Each partial
    product is exact in fp32 (two 11-bit significands) and summed in
    fp32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   scale: Optional[float] = None,
                   passes: int = 3, prefix_len: int = 0) -> torch.Tensor:
    """``attention_ref`` with QK^T and PV as the flash kernel computes them
    on the tensor cores (``tf32_matmul`` with ``passes``): the scale applied
    to the product, the softmax in fp32. q, k, v: [B, H, S, D]. A test
    oracle of the kernel's arithmetic; nothing on the main path calls it."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = tf32_matmul(q, k.transpose(-1, -2), passes) * scale
    ok = keep_mask(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device)
    probs = torch.softmax(torch.where(ok, logits, NEG_INF), dim=-1)
    return tf32_matmul(probs, v, passes).to(q.dtype)


def _gqa_logits(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                window: int, scale: Optional[float], prefix_len: int):
    """(masked logits [B, H, S, S], the mask, k repeated to H heads, scale)
    of q [B, H, S, D] against k [B, Hkv, S, D] (head h reads kv head h //
    (H / Hkv)), in q's precision, fp32 at least."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.to(dtype).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(dtype), kr) * scale
    ok = keep_mask(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device)
    return torch.where(ok, logits, NEG_INF), ok, kr, scale


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      prefix_len: int = 0) -> torch.Tensor:
    """The row logsumexp the forward kernel writes for training: q [B, H,
    S, D], k [B, Hkv, S, D] -> [B, H, S], the log of each query row's
    softmax denominator over its kept keys (``keep_mask``), in natural
    units, in q's precision (fp32 at least)."""
    logits, _, _, _ = _gqa_logits(q, k, causal=causal, window=window,
                                  scale=scale, prefix_len=prefix_len)
    return torch.logsumexp(logits, dim=-1)


def _group_sum(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, Hkv, S, D]: each kv head's group of query heads
    summed in order, head 0 first, as the backward kernel adds them."""
    x = x.unflatten(1, (n_kv, x.shape[1] // n_kv))
    acc = x[:, :, 0]
    for r in range(1, x.shape[2]):
        acc = acc + x[:, :, r]
    return acc


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      scale: Optional[float] = None, prefix_len: int = 0):
    """The backward kernel's algorithm (``csrc/flash_attention_bwd.cu``) in
    plain torch: q, o, do [B, H, S, D]; k, v [B, Hkv, S, D]; lse [B, H, S]
    the forward's. Returns (dq [B, H, S, D], dk, dv [B, Hkv, S, D]).

    The probabilities are recomputed from lse, P = exp(scale Q K^T - lse)
    and 0 where ``keep_mask`` drops a pair; D = rowsum(dO * O); dV = P^T
    dO, dS = P (dO V^T - D), dK = scale dS^T Q, dQ = scale dS K. A kv head's
    dK and dV are its group's query heads summed in order, head 0 first, as
    the kernel's kv-tile-major pass adds them. In q's precision (fp32 at
    least)."""
    logits, ok, kr, scale = _gqa_logits(q, k, causal=causal, window=window,
                                        scale=scale, prefix_len=prefix_len)
    dtype = logits.dtype
    q, v, o, do = (x.to(dtype) for x in (q, v, o, do))
    rep = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(rep, dim=1)
    p = torch.where(ok, torch.exp(logits - lse.to(dtype)[..., None]), 0.0)
    delta = (do * o).sum(dim=-1)
    dp = torch.einsum("bhsd,bhtd->bhst", do, vr)
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhst,bhtd->bhsd", ds, kr)
    dk_h = scale * torch.einsum("bhst,bhsd->bhtd", ds, q)
    dv_h = torch.einsum("bhst,bhsd->bhtd", p, do)
    return dq, _group_sum(dk_h, k.shape[1]), _group_sum(dv_h, k.shape[1])


def attention_bwd_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       scale: Optional[float] = None, prefix_len: int = 0,
                       passes: int = 3):
    """``attention_bwd_ref`` with its five products as the backward kernel
    computes them on the tensor cores (``tf32_matmul`` with ``passes``):
    S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q and dQ = dS K, fp32
    between them; P = exp2(S (scale log2 e) - lse log2 e), as the kernel
    takes it with ex2; dK and dQ scaled after the product, a kv head's dK
    and dV its group's query heads summed in order. Same arguments and
    returns as ``attention_bwd_ref``, fp32. A test oracle of the kernel's
    arithmetic; nothing on the main path calls it."""
    f32 = torch.float32
    q, k, v, o, do = (x.to(f32) for x in (q, k, v, o, do))
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    log2e = torch.tensor(LOG2E, dtype=f32)
    scale_log2 = torch.tensor(scale, dtype=f32) * log2e
    logits = tf32_matmul(q, kr.transpose(-1, -2), passes)
    ok = keep_mask(s, causal=causal, window=window, prefix_len=prefix_len,
                   device=q.device)
    p = torch.where(ok, torch.exp2(logits * scale_log2
                                   - lse.to(f32)[..., None] * log2e), 0.0)
    delta = (do * o).sum(dim=-1)
    dp = tf32_matmul(do, vr.transpose(-1, -2), passes)
    ds = p * (dp - delta[..., None])
    dq = tf32_matmul(ds, kr, passes) * scale
    dk_h = tf32_matmul(ds.transpose(-1, -2), q, passes) * scale
    dv_h = tf32_matmul(p.transpose(-1, -2), do, passes)
    return dq, _group_sum(dk_h, k.shape[1]), _group_sum(dv_h, k.shape[1])
