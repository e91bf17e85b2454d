"""The port's xLSTM (``models/xlstm.py``) against the JAX package's, on the
CPU: the mLSTM forward in both forms (the chunk rule, the reference test's
chunk cases, the sequential form), the sLSTM forward, both decode steps,
and the whole xlstm-125m smoke model's prefill and cached decode, with the
reference's params carried across by ``weights.lm_params_from_jax``.

Tolerance: atol 3e-5 / rtol 1e-4 on a layer's output and state, as the
reference holds its chunkwise mLSTM to its sequential form
(``tests/test_kernels.py``); 2e-4 on logits, as its decode-consistency
tests take them. Both sides compute in fp32; the port sums in another
order (its sLSTM projects the whole sequence before the time loop, its
recurrent product is one batched GEMM over the heads).
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import registry, transformer, xlstm
from repro_torch.weights import lm_params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ARCH = "xlstm-125m"
ATOL, RTOL = 3e-5, 1e-4
LOGIT_TOL = 2e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _to_torch(tree):
    return lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _cfgs():
    jcfg, cfg = jconfigs.get_smoke_arch(ARCH), configs.get_smoke_arch(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _x(b, t, d, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((b, t, d))
            * scale).astype(np.float32)


def _states_close(got, want):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,want", [(8, 0), (100, 0), (128, 0), (256, 128),
                                    (2048, 128), (2040, 120), (4095, 117),
                                    (96, 0), (192, 96), (17 * 13, 17),
                                    (13 * 131, 0)])
def test_mlstm_chunk_rule_is_the_references(t, want):
    """The largest divisor of t up to MLSTM_CHUNK, none below 16, and
    chunkwise only when t exceeds it (0: the sequential form)."""
    assert xlstm.mlstm_chunk(t) == want
    assert xlstm.mlstm_chunk(t, 0) == 0
    assert xlstm.mlstm_chunk(256, 48) == 0      # 48 does not divide 256
    assert xlstm.mlstm_chunk(64, 64) == 0       # not below t
    assert xlstm.mlstm_chunk(64, 16) == 16


# (B, T, chunk): the sequential form forced; the reference test's chunk
# cases; the default rule at T in {8, 128, 256}
MLSTM_CASES = [(2, 64, 0), (2, 256, 32), (3, 64, 16), (2, 512, 128),
               (1, 96, 32), (2, 8, None), (2, 128, None), (2, 256, None)]


@pytest.mark.parametrize("case", MLSTM_CASES,
                         ids=lambda c: f"B{c[0]}T{c[1]}L{c[2]}")
def test_mlstm_forward_matches_reference(case):
    """Output and every state leaf (C, n, m, conv) against the JAX
    function with the same ``chunk``."""
    b, t, chunk = case
    jcfg, cfg = _cfgs()
    jp = jxlstm.init_mlstm(jax.random.key(0), jcfg)
    x = _x(b, t, cfg.d_model, seed=t)
    want, want_state = jxlstm.mlstm_forward(jp, jcfg, jnp.asarray(x),
                                            chunk=chunk)
    got, state = xlstm.mlstm_forward(_to_torch(jp), cfg, torch.from_numpy(x),
                                     chunk=chunk)
    _close(got, want)
    _states_close(state, want_state)


def test_mlstm_chunkwise_matches_the_port_sequential_form():
    """The port against itself, as the reference test holds its own: the
    chunkwise form at T 2040 (17 chunks of 120) against the recurrence."""
    _, cfg = _cfgs()
    params = xlstm.init_mlstm(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(_x(1, 2040, cfg.d_model, seed=5))
    seq, seq_state = xlstm.mlstm_forward(params, cfg, x, chunk=0)
    chk, chk_state = xlstm.mlstm_forward(params, cfg, x)
    torch.testing.assert_close(chk, seq, atol=ATOL, rtol=RTOL)
    for key in seq_state:
        torch.testing.assert_close(chk_state[key], seq_state[key], atol=ATOL,
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# sLSTM and both decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,t", [(2, 40), (1, 1), (3, 17)])
def test_slstm_forward_matches_reference(b, t):
    jcfg, cfg = _cfgs()
    jp = jxlstm.init_slstm(jax.random.key(1), jcfg)
    x = _x(b, t, cfg.d_model, seed=t, scale=1.0)
    want, want_state = jxlstm.slstm_forward(jp, jcfg, jnp.asarray(x))
    got, state = xlstm.slstm_forward(_to_torch(jp), cfg, torch.from_numpy(x))
    _close(got, want)
    _states_close(state, want_state)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference(kind):
    """From the state a 24-token forward leaves (and from a zeroed state),
    6 decode steps on both sides: each step's output, and the state the
    port writes in place against the reference's returned state."""
    jcfg, cfg = _cfgs()
    init = {"mlstm": jxlstm.init_mlstm, "slstm": jxlstm.init_slstm}[kind]
    jfwd = {"mlstm": jxlstm.mlstm_forward, "slstm": jxlstm.slstm_forward}
    jdec = {"mlstm": jxlstm.mlstm_decode, "slstm": jxlstm.slstm_decode}
    fwd = {"mlstm": xlstm.mlstm_forward, "slstm": xlstm.slstm_forward}
    dec = {"mlstm": xlstm.mlstm_decode, "slstm": xlstm.slstm_decode}
    jzero = {"mlstm": jxlstm.init_mlstm_state,
             "slstm": jxlstm.init_slstm_state}
    zero = {"mlstm": xlstm.init_mlstm_state, "slstm": xlstm.init_slstm_state}
    jp = init(jax.random.key(2), jcfg)
    p = _to_torch(jp)
    x = _x(2, 30, cfg.d_model, seed=9, scale=1.0)
    _, jstate = jfwd[kind](jp, jcfg, jnp.asarray(x[:, :24]))
    _, state = fwd[kind](p, cfg, torch.from_numpy(x[:, :24]))
    starts = [(jstate, state),
              (jzero[kind](jcfg, 2), zero[kind](cfg, 2, device="cpu"))]
    for jst, st in starts:
        for t in range(24, 30):
            jout, jst = jdec[kind](jp, jcfg, jnp.asarray(x[:, t]), jst)
            leaves = dict(st)
            out, st2 = dec[kind](p, cfg, torch.from_numpy(x[:, t]), st)
            assert st2 is st and all(st[k] is leaves[k] for k in leaves)
            _close(out, jout)
            _states_close(st, jst)


def test_state_allocators_are_the_references():
    jcfg, cfg = _cfgs()
    for jfn, fn in ((jxlstm.init_mlstm_state, xlstm.init_mlstm_state),
                    (jxlstm.init_slstm_state, xlstm.init_slstm_state)):
        want = jfn(jcfg, 3)
        got = fn(cfg, 3, device="cpu")
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _run_reference(jcfg, jparams, toks, s0):
    prefill = jax.jit(lambda p, t: jtransformer.prefill(
        p, jcfg, {"tokens": t}, max_len=toks.shape[1]))
    decode = jax.jit(lambda p, s, t, i: jtransformer.decode_step(
        p, jcfg, s, t, i))
    logits, state = prefill(jparams, jnp.asarray(toks[:, :s0]))
    out = [np.asarray(logits)]
    for t in range(s0, toks.shape[1]):
        logits, state = decode(jparams, state, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        out.append(np.asarray(logits))
    return out, state


@pytest.mark.parametrize("s0", [12, 64])
def test_xlstm_prefill_and_decode_match_reference(s0):
    """xlstm-125m smoke (an mLSTM and an sLSTM block): prefill of s0 tokens
    (12: sequential mLSTM; 64: chunkwise, 2 chunks of 32), then 4
    teacher-forced decode steps; logits at every step and the final
    recurrent states."""
    jcfg, cfg = _cfgs()
    jparams = jtransformer.init_lm(jax.random.key(1), jcfg)
    params = _to_torch(jparams)
    b, s1 = 2, 4
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(b, s0 + s1)).astype(np.int32)
    want, want_state = _run_reference(jcfg, jparams, toks, s0)
    tt = torch.from_numpy(toks).long()
    logits, state = transformer.prefill(params, cfg, {"tokens": tt[:, :s0]},
                                        max_len=s0 + s1)
    got = [logits]
    for t in range(s0, s0 + s1):
        logits, state = transformer.decode_step(params, cfg, state, tt[:, t],
                                                t)
        got.append(logits)
    for g, w in zip(got, want):
        _close(g, w, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for j in want_state["period"]:
        _states_close(state["period"][j], want_state["period"][j])


def test_xlstm_decode_from_empty_state_matches_forward():
    """The port against itself: token-by-token decode from a zeroed state
    gives the full forward's logits (chunkwise mLSTM at S = 64) at every
    position."""
    _, cfg = _cfgs()
    params = registry.init_model(torch.Generator().manual_seed(0), cfg)
    b, s = 2, 64
    batch = registry.make_prefill_batch(
        torch.Generator().manual_seed(1), cfg,
        configs.ShapeConfig("t", s, b, "prefill"))
    h, _, _ = transformer.forward(
        params, cfg, transformer._embed_inputs(params, cfg, batch)[0])
    full = transformer._lm_head(params, cfg, h)
    state = transformer.init_decode_state(cfg, b, s, device="cpu")
    for t in range(s):
        logits, state = transformer.decode_step(params, cfg, state,
                                                batch["tokens"][:, t], t)
        _close(logits, full[:, t].numpy(), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_lm_params_from_jax_carries_xlstm_leaves():
    """Every leaf equal, the recurrent weights stacked over periods, and the
    same tree and shapes as the port's own init draws."""
    jcfg, cfg = _cfgs()
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    params = _to_torch(jparams)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_array_equal(got, want)
    _, _, hd = xlstm._dims(cfg)
    slstm = params["period"]["j1"]["mixer"]
    for g in "zifo":
        assert slstm[f"r_{g}"].shape == (1, cfg.n_heads, hd, hd)
    assert params["period"]["j0"]["mixer"]["f_bias"].shape == (1, cfg.n_heads)
    own = registry.init_model(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes


def test_one_h100_xlstm_is_the_published_config():
    assert configs.get_one_h100_arch(ARCH) == configs.get_arch(ARCH)
    cfg = configs.get_one_h100_arch(ARCH)
    assert cfg.layer_kinds() == ("mlstm",) * 3 + ("slstm",) + \
        ("mlstm",) * 3 + ("slstm",) + ("mlstm",) * 3 + ("slstm",)
    assert xlstm._dims(cfg)[1:] == (1536, 384)


def test_serve_xlstm_on_cpu():
    """``launch.serve --arch xlstm-125m`` at its smoke size on the CPU:
    the reference's keys, no kernel launch (xLSTM runs none)."""
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "40", "--gen", "4"])
    printed = json.loads(out.getvalue())
    assert printed["arch"] == "xlstm-125m-smoke" and printed["finite"]
    assert printed["generated_tokens"] == 8
    assert set(printed["launches"].values()) == {0}
