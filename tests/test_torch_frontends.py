"""The port's VLM patch prefix with its prefix-LM mask, and the audio
encoder, against the JAX package's, on the CPU: the flash kernel's plain
versions (``attention_ref``, ``mha_ref``, the 3xTF32 emulation
``attention_tf32``) with ``prefix_len`` against the reference's
``build_mask`` + ``_sdpa``; GQA and MLA forwards with the prefix; the
paligemma-3b smoke model's prefill and cached decode; the hubert-xlarge
smoke encoder's forward and prefill with and without ``mask_positions``;
the serve entry point and the prompt batches (a VLM prompt of the patches
alone among them). Params carried across by
``weights.lm_params_from_jax``.

Tolerance: rtol / atol 3e-5 on attention outputs (fp32 sums in another
order, as the flash tests hold the kernel's plain version); 1e-5 on the
GQA and MLA layers, as ``tests/test_torch_lm.py``; 2e-4 on logits and
hidden states of whole models, as the reference's decode-consistency
tests take them.
"""
import argparse
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
from repro.launch import serve as jserve
from repro.models import attention as jattention
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs, kernels
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import serve
from repro_torch.models import attention, registry, transformer
from repro_torch.weights import lm_params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ATTN_TOL = 3e-5
LAYER_TOL = 1e-5
LOGIT_TOL = 2e-4
S = 130   # the masks' sequence length: past the largest fixed prefix
PREFIXES = [0, 1, 16, 100, S, S + 5]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _to_torch(tree):
    return lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _pair(arch):
    jcfg, cfg = jconfigs.get_smoke_arch(arch), configs.get_smoke_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the mask and the kernel's plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_keep_mask_is_build_mask(prefix, causal, window):
    want = np.asarray(jattention.build_mask(
        S, causal=causal, prefix_len=prefix, sliding_window=window)) == 0
    got = flash_ref.keep_mask(S, causal=causal, window=window,
                              prefix_len=prefix, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _reference_attention(q, k, v, causal, window, prefix):
    """The JAX model's path: ``build_mask`` + ``_sdpa`` on [B, S, H, D],
    kv repeated to H heads."""
    h = q.shape[2]
    mask = jattention.build_mask(q.shape[1], causal=causal,
                                 prefix_len=prefix, sliding_window=window)
    return np.asarray(jattention._sdpa(
        jnp.asarray(q), jattention._repeat_kv(jnp.asarray(k), h),
        jattention._repeat_kv(jnp.asarray(v), h), mask,
        q.shape[-1] ** -0.5))


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("window", [0, 24])
def test_plain_versions_with_prefix_match_reference(prefix, window):
    """``attention_ref`` (H = Hkv), ``mha_ref`` under GQA (4 heads over 2)
    and the 3xTF32 emulation ``attention_tf32``, causal with the prefix,
    against ``build_mask`` + ``_sdpa``; and the wrappers on CPU tensors."""
    b, h, hkv, d = 2, 4, 2, 32
    q = _normal((b, S, h, d), prefix + 1)
    k, v = _normal((b, S, hkv, d), 7), _normal((b, S, hkv, d), 8)
    want = _reference_attention(q, k, v, True, window, prefix)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_ref.mha_ref(tq, tk, tv, causal=True, window=window,
                            prefix_len=prefix)
    _close(got, want, ATTN_TOL)
    kernels.reset_launch_counts()
    _close(flash_ops.mha(tq, tk, tv, causal=True, window=window,
                         prefix_len=prefix), want, ATTN_TOL)
    # H = Hkv, the TPU kernel's [B, H, S, D] layout
    k4, v4 = (np.repeat(x, h // hkv, axis=2) for x in (k, v))
    want4 = _reference_attention(q, k4, v4, True, window, prefix)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k4, v4))
    for fn in (flash_ref.attention_ref, flash_ref.attention_tf32,
               flash_ops.flash_attention):
        out = fn(qt, kt, vt, causal=True, window=window, prefix_len=prefix)
        _close(out.transpose(1, 2), want4, ATTN_TOL)
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the attention layers with a prefix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [0, 7, 24])
def test_gqa_forward_with_prefix_matches_reference(prefix):
    jcfg, cfg = _pair("paligemma-3b")
    jp = jattention.init_attention(jax.random.key(0), jcfg)
    b, s = 2, 24
    x = _normal((b, s, cfg.d_model), 3)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    mask = {"causal": True, "prefix_len": prefix, "window": 0}
    want, want_kv = jattention.gqa_forward(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), mask)
    got, kv = attention.gqa_forward(_to_torch(jp), cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), mask)
    _close(got, want, LAYER_TOL)
    for key in ("k", "v"):
        _close(kv[key], want_kv[key], LAYER_TOL)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("prefix", [0, 9])
def test_mla_forward_with_prefix_matches_reference(absorbed, prefix):
    """MLA in both forms reads the same ``prefix_len`` as the reference's
    ``mla_forward``: the materialized form through the flash wrapper, the
    absorbed one through its dense mask."""
    jcfg = jconfigs.get_smoke_arch("deepseek-v2-236b")
    cfg = configs.get_smoke_arch("deepseek-v2-236b")
    jp = jattention.init_attention(jax.random.key(0), jcfg)
    b, s = 2, 20
    x = _normal((b, s, cfg.d_model), 4)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    mask = {"causal": True, "prefix_len": prefix, "window": 0}
    want, _ = jattention.mla_forward(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), mask,
                                     absorbed=absorbed)
    got, _ = attention.mla_forward(_to_torch(jp), cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()), mask,
                                   absorbed=absorbed)
    _close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# paligemma: the VLM prefix
# ---------------------------------------------------------------------------


def _vlm_batch(cfg, b, s_txt, seed):
    rng = np.random.default_rng(seed)
    return (_normal((b, cfg.vlm_prefix_len, cfg.d_model), seed),
            rng.integers(0, cfg.vocab, size=(b, s_txt)).astype(np.int32))


def test_paligemma_prefill_and_decode_match_reference():
    """paligemma smoke: prefill of 16 patches + 12 text tokens under the
    prefix-LM mask, then 4 teacher-forced text decode steps; logits at every
    step."""
    jcfg, cfg = _pair("paligemma-3b")
    jparams = jtransformer.init_lm(jax.random.key(1), jcfg)
    params = _to_torch(jparams)
    b, s0, s1 = 2, 12, 4
    patches, toks = _vlm_batch(cfg, b, s0 + s1, 6)
    p = cfg.vlm_prefix_len
    max_len = p + s0 + s1
    prefill = jax.jit(lambda prm, pa, t: jtransformer.prefill(
        prm, jcfg, {"patches": pa, "tokens": t}, max_len=max_len))
    decode = jax.jit(lambda prm, st, t, i: jtransformer.decode_step(
        prm, jcfg, st, t, i))
    logits, state = prefill(jparams, jnp.asarray(patches),
                            jnp.asarray(toks[:, :s0]))
    want = [np.asarray(logits)]
    for t in range(s0, s0 + s1):
        logits, state = decode(jparams, state, jnp.asarray(toks[:, t]),
                               jnp.int32(p + t))
        want.append(np.asarray(logits))
    tt = torch.from_numpy(toks).long()
    logits, state = transformer.prefill(
        params, cfg, {"patches": torch.from_numpy(patches),
                      "tokens": tt[:, :s0]}, max_len=max_len)
    got = [logits]
    for t in range(s0, s0 + s1):
        logits, state = transformer.decode_step(params, cfg, state, tt[:, t],
                                                p + t)
        got.append(logits)
    for g, w in zip(got, want):
        _close(g, w, LOGIT_TOL)


def test_paligemma_forward_matches_reference_at_every_position():
    """The hidden states of one forward over patches and text, at every
    position, against the JAX forward (the prefix square is bidirectional:
    a patch's state depends on later patches)."""
    jcfg, cfg = _pair("paligemma-3b")
    jparams = jtransformer.init_lm(jax.random.key(2), jcfg)
    params = _to_torch(jparams)
    patches, toks = _vlm_batch(cfg, 2, 10, 3)
    jbatch = {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks)}
    jx, _, _ = jtransformer._embed_inputs(jparams, jcfg, jbatch)
    want, _, _ = jtransformer.forward(jparams, jcfg, jx, remat=False)
    x, _, _ = transformer._embed_inputs(
        params, cfg, {"patches": torch.from_numpy(patches),
                      "tokens": torch.from_numpy(toks).long()})
    _close(x, jx, LAYER_TOL)
    got, _, _ = transformer.forward(params, cfg, x)
    _close(got, want, LOGIT_TOL)
    # the prefix matters: the same stack without it gives other states
    plain = dataclasses.replace(cfg, family="dense")
    other, _, _ = transformer.forward(params, plain, x)
    assert float((other[:, :cfg.vlm_prefix_len] - got[:, :cfg.vlm_prefix_len])
                 .abs().max()) > 1e-3


def test_paligemma_decode_matches_forward():
    """The port against itself: prefill of the patches and 2 text tokens,
    then 8 decode steps, against one forward over all of them."""
    _, cfg = _pair("paligemma-3b")
    params = registry.init_model(torch.Generator().manual_seed(0), cfg)
    p, n = cfg.vlm_prefix_len, 10
    batch = registry.make_prefill_batch(
        torch.Generator().manual_seed(1), cfg,
        configs.ShapeConfig("t", p + n, 2, "prefill"))
    h, _, _ = transformer.forward(
        params, cfg, transformer._embed_inputs(params, cfg, batch)[0])
    full = transformer._lm_head(params, cfg, h)
    toks = batch["tokens"]
    logits, state = transformer.prefill(
        params, cfg, {"patches": batch["patches"], "tokens": toks[:, :2]},
        max_len=p + n)
    _close(logits, full[:, p + 1].numpy(), LOGIT_TOL)
    for t in range(2, n):
        logits, state = transformer.decode_step(params, cfg, state,
                                                toks[:, t], p + t)
        _close(logits, full[:, p + t].numpy(), LOGIT_TOL)


# ---------------------------------------------------------------------------
# hubert: the audio encoder
# ---------------------------------------------------------------------------


def _audio_batch(cfg, b, s, seed, masked):
    batch = {"frames": _normal((b, s, cfg.d_model), seed)}
    if masked:
        batch["mask_positions"] = (np.random.default_rng(seed + 1)
                                   .random((b, s)) < 0.3).astype(np.int32)
    return batch


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_forward_and_prefill_match_reference(masked):
    """hubert smoke: the encoder's input (frames, ``mask_emb`` at the masked
    positions, the positional conv), its bidirectional forward and the head
    logits over every frame; then ``prefill``'s last-frame logits and its
    kv caches."""
    jcfg, cfg = _pair("hubert-xlarge")
    jparams = jtransformer.init_lm(jax.random.key(3), jcfg)
    params = _to_torch(jparams)
    batch = _audio_batch(cfg, 2, 24, 5, masked)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jx, _, _ = jtransformer._embed_inputs(jparams, jcfg, jbatch)
    x, _, _ = transformer._embed_inputs(params, cfg, tbatch)
    _close(x, jx, LAYER_TOL)
    jh, _, _ = jtransformer.forward(jparams, jcfg, jx, remat=False)
    h, _, _ = transformer.forward(params, cfg, x)
    _close(h, jh, LOGIT_TOL)
    _close(transformer._lm_head(params, cfg, h),
           jtransformer._lm_head(jparams, jcfg, jh), LOGIT_TOL)
    jlogits, jstate = jtransformer.prefill(jparams, jcfg, jbatch)
    logits, state = transformer.prefill(params, cfg, tbatch)
    _close(logits, jlogits, LOGIT_TOL)
    for key in ("k", "v"):
        _close(state["period"]["j0"][key], jstate["period"]["j0"][key],
               LOGIT_TOL)
    if masked:   # the mask embedding took the masked frames' place
        plain, _, _ = transformer._embed_inputs(
            params, cfg, {"frames": tbatch["frames"]})
        assert not torch.allclose(plain, x)


def test_serve_exits_on_an_encoder_as_the_reference_does():
    args = ["--arch", "hubert-xlarge"]
    with pytest.raises(SystemExit, match="encoder-only") as want:
        jserve.serve(argparse.Namespace(arch="hubert-xlarge", prompt_len=8,
                                        gen=2, batch=1, seed=0))
    with pytest.raises(SystemExit, match="encoder-only") as got:
        serve.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# batches, params, configs, the serve entry point
# ---------------------------------------------------------------------------


def test_make_prefill_batch_lays_out_the_references_inputs():
    gen = torch.Generator().manual_seed(0)
    shape = configs.ShapeConfig("t", 40, 3, "prefill")
    vlm = configs.get_smoke_arch("paligemma-3b")
    batch = registry.make_prefill_batch(gen, vlm, shape)
    assert batch["patches"].shape == (3, 16, vlm.d_model)
    assert batch["patches"].dtype == torch.float32
    assert batch["tokens"].shape == (3, 24)
    assert int(batch["tokens"].max()) < vlm.vocab
    audio = configs.get_smoke_arch("hubert-xlarge")
    batch = registry.make_prefill_batch(gen, audio, shape)
    assert set(batch) == {"frames"}
    assert batch["frames"].shape == (3, 40, audio.d_model)
    # a prompt of the patches alone (S = P) has an empty token block, as
    # the reference builds it; a shorter one raises in both packages
    batch = registry.make_prefill_batch(
        gen, vlm, configs.ShapeConfig("t", 16, 3, "prefill"))
    assert batch["patches"].shape == (3, 16, vlm.d_model)
    assert batch["tokens"].shape == (3, 0)
    with pytest.raises(ValueError, match="shorter than"):
        registry.make_prefill_batch(
            gen, vlm, configs.ShapeConfig("t", 15, 1, "prefill"))


def test_vlm_prompt_of_only_patches_serves_as_the_reference():
    """S = P: the reference's prompt batch of the patches and ``tokens
    [B, 0]`` through ``_embed_inputs``, the prefix mask and ``prefill``:
    finite last-position logits [B, V] equal to the JAX package's at the
    whole-model tolerance, and a cache of P positions."""
    jcfg, cfg = _pair("paligemma-3b")
    p = cfg.vlm_prefix_len
    jparams = jtransformer.init_lm(jax.random.key(4), jcfg)
    params = _to_torch(jparams)
    jbatch = jregistry.make_prefill_batch(
        jax.random.key(5), jcfg, jconfigs.ShapeConfig("t", p, 2, "prefill"))
    assert jbatch["tokens"].shape == (2, 0)
    jlogits, _ = jtransformer.prefill(jparams, jcfg, jbatch)
    batch = {"patches": torch.from_numpy(np.array(jbatch["patches"])),
             "tokens": torch.zeros((2, 0), dtype=torch.int64)}
    logits, state = transformer.prefill(params, cfg, batch)
    assert logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    _close(logits, jlogits, LOGIT_TOL)
    assert state["period"]["j0"]["k"].shape[2] == p


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_lm_params_from_jax_carries_frontend_leaves(arch):
    """Every leaf equal (hubert's ``mask_emb`` and ``pos_conv`` among
    them), and the port's own init draws the same tree and shapes."""
    jcfg, cfg = _pair(arch)
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    params = _to_torch(jparams)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        np.testing.assert_array_equal(got, want)
    if cfg.audio_frontend:
        assert params["mask_emb"].shape == (cfg.d_model,)
        assert params["pos_conv"]["w"].shape == (4, cfg.d_model)
    own = registry.init_model(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_one_h100_is_the_published_config(arch):
    cfg = configs.get_one_h100_arch(arch)
    assert cfg == configs.get_arch(arch)
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jconfigs.get_arch(arch))


def test_serve_paligemma_on_cpu():
    """``launch.serve --arch paligemma-3b`` at its smoke size on the CPU:
    the prompt is 16 patches and 24 text tokens; the reference's keys, no
    kernel launch (the CPU takes the plain versions)."""
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--arch", "paligemma-3b", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "40", "--gen", "3"])
    printed = json.loads(out.getvalue())
    assert printed["arch"] == "paligemma-3b-smoke" and printed["finite"]
    assert printed["generated_tokens"] == 6
    assert set(printed["launches"].values()) == {0}
