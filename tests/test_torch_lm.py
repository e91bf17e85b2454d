"""The port's LM serving path against the JAX package's, on the CPU: the
configs, the layers, GQA forward and decode, and prefill + cached decode
of whole smoke models, with the reference's params carried across by
``weights.lm_params_from_jax``.

Tolerance: rtol / atol 1e-5 on activations and logits (unit-scale logits
at this init): the same fp32 ops, matmuls and reductions summed in another
order. JAX runs its own way: ``prefill`` and ``decode_step`` under
``jax.jit``, attention through its dense-mask ``_sdpa``, Mamba through its
``lax.scan``; the port's attention runs the flash wrapper's plain version
and its Mamba the scan wrapper's.
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
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.core import detection
from repro_torch.models import (attention, layers, registry, ssm,
                                 transformer)
from repro_torch.weights import lm_params_from_jax

RTOL = ATOL = 1e-5
# the five smoke configs the serve slice covers, plus kimi's (a dense
# prefix block), each without MoE on both sides
SERVE_ARCHS = ["phi4-mini-3.8b", "qwen3-32b", "nemotron-4-15b", "minicpm-2b",
               "jamba-1.5-large-398b", "kimi-k2-1t-a32b"]
REFERENCE_SERVE_KEYS = {"arch", "batch", "prompt_len", "generated_tokens",
                        "prefill_s", "decode_s", "tokens_per_s", "sample",
                        "finite"}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _to_torch(tree):
    return lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _pair(arch, **changes):
    """(reference config, port config) of an arch's smoke size, with MoE
    off on both sides and ``changes`` applied; equal field for field."""
    jcfg = jconfigs.get_smoke_arch(arch)
    cfg = configs.get_smoke_arch(arch)
    if jcfg.moe is not None:
        changes = {"moe": None, **changes}
    jcfg = dataclasses.replace(jcfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(jconfigs.arch_ids()))
def test_configs_are_the_reference_data(arch):
    for size in ("get_arch", "get_smoke_arch"):
        want = getattr(jconfigs, size)(arch)
        got = getattr(configs, size)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert tuple(configs.arch_ids()) == tuple(jconfigs.arch_ids())


def test_one_h100_config_is_jamba_cut_to_one_period_without_moe():
    cfg = configs.get_one_h100_arch("jamba-1.5-large-398b")
    full = configs.get_arch("jamba-1.5-large-398b")
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(full),
                                       "name": cfg.name, "n_layers": 8,
                                       "moe": None}
    assert cfg.layer_kinds() == ("ssm",) * 3 + ("attn",) + ("ssm",) * 4
    assert 8.99e9 < cfg.param_count() < 9.01e9     # 36.0 GB in fp32
    with pytest.raises(ValueError):
        configs.get_one_h100_arch("phi4-mini-3.8b")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(kind):
    jp = jlayers.mlp_init(jax.random.key(0), 32, 48, kind)
    x = _rng(1).normal(size=(2, 5, 32)).astype(np.float32)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), kind)
    _close(layers.mlp_apply(_to_torch(jp), torch.from_numpy(x), kind), want)


def test_norm_rope_and_conv_match_reference():
    rng = _rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    scale = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    _close(layers.rms_norm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x), 1e-6),
           jlayers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-6))
    jconv = jlayers.causal_conv_init(jax.random.key(3), 24, 4)
    jconv["b"] = jnp.asarray(rng.normal(size=24).astype(np.float32))
    conv = _to_torch(jconv)
    u = rng.normal(size=(2, 9, 24)).astype(np.float32)
    _close(layers.causal_conv_apply(conv, torch.from_numpy(u)),
           jlayers.causal_conv_apply(jconv, jnp.asarray(u)))
    st = rng.normal(size=(2, 3, 24)).astype(np.float32)
    out, new = layers.causal_conv_step(conv, torch.from_numpy(st),
                                       torch.from_numpy(u[:, 0]))
    jout, jnew = jlayers.causal_conv_step(jconv, jnp.asarray(st),
                                          jnp.asarray(u[:, 0]))
    _close(out, jout)
    _close(new, jnew)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_forward_and_ring_decode_match_reference(window):
    """qwen3's smoke attention (qk-norm, 4 query heads over 2 kv heads),
    with and without a sliding window: the full-sequence forward, then 20
    decode steps through a cache that wraps when windowed."""
    jcfg, cfg = _pair("qwen3-32b", sliding_window=window)
    jp = jattention.init_attention(jax.random.key(4), jcfg)
    p = _to_torch(jp)
    b, s = 2, 20
    x = _rng(5).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    mask = {"causal": True, "prefix_len": 0, "window": window}
    jout, jkv = jattention.gqa_forward(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), mask)
    out, kv = attention.gqa_forward(p, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), mask)
    _close(out, jout)
    _close(kv["k"], jkv["k"])
    jcache = jattention.init_cache(jcfg, b, s)
    cache = attention.init_cache(cfg, b, s, device="cpu")
    assert cache["k"].shape == tuple(jcache["k"].shape)
    for t in range(s):
        jo, jcache = jattention.gqa_decode(jp, jcfg, jnp.asarray(x[:, t]),
                                           jnp.int32(t), jcache)
        o, cache = attention.gqa_decode(p, cfg, torch.from_numpy(x[:, t]), t,
                                        cache)
        _close(o, jo)
        _close(o, out[:, t])          # decode agrees with the forward
    _close(cache["v"], jcache["v"])


# ---------------------------------------------------------------------------
# whole models: prefill + cached decode
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
    return out


@pytest.mark.parametrize("arch,window", [(a, 0) for a in SERVE_ARCHS]
                         + [("phi4-mini-3.8b", 8)])
def test_prefill_and_decode_match_reference(arch, window):
    """prefill of 12 tokens, then 4 teacher-forced decode steps (with a
    window of 8 the prefill leaves a wrapped ring cache)."""
    jcfg, cfg = _pair(arch, sliding_window=window)
    jparams = jtransformer.init_lm(jax.random.key(1), jcfg)
    params = _to_torch(jparams)
    b, s0, s1 = 2, 12, 4
    toks = _rng(6).integers(0, cfg.vocab, size=(b, s0 + s1)).astype(np.int32)
    want = _run_reference(jcfg, jparams, toks, s0)
    tt = torch.from_numpy(toks).long()
    logits, state = transformer.prefill(params, cfg, {"tokens": tt[:, :s0]},
                                        max_len=s0 + s1)
    got = [logits]
    for t in range(s0, s0 + s1):
        logits, state = transformer.decode_step(params, cfg, state, tt[:, t],
                                                t)
        got.append(logits)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "phi4-mini-3.8b"])
def test_decode_from_empty_state_matches_forward(arch):
    """The port against itself: token-by-token decode from an empty state
    (plain torch) gives the full forward's logits (the kernels' wrappers)
    at every position."""
    _, cfg = _pair(arch)
    params = registry.init_model(torch.Generator().manual_seed(0), cfg)
    b, s = 2, 16
    batch = registry.make_prefill_batch(
        torch.Generator().manual_seed(1), cfg,
        configs.ShapeConfig("t", s, b, "prefill"))
    h, caches = transformer.forward(
        params, cfg, transformer._embed_inputs(params, cfg, batch))
    assert caches is None
    full = transformer._lm_head(params, cfg, h)
    state = transformer.init_decode_state(cfg, b, s, device="cpu")
    for t in range(s):
        logits, state = transformer.decode_step(params, cfg, state,
                                                batch["tokens"][:, t], t)
        _close(logits, full[:, t])


def test_lm_params_from_jax_keeps_the_tree():
    jcfg, _ = _pair("kimi-k2-1t-a32b")
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    params = _to_torch(jparams)
    jleaves, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    assert isinstance(params["prefix"], list)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        lm_params_from_jax({"w": np.arange(3)}, "cpu")


# ---------------------------------------------------------------------------
# the serve entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-32b"],
    ["--arch", "phi4-mini-3.8b", "--prompt-len", "9", "--gen", "1"]])
def test_serve_on_cpu_prints_the_reference_keys(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        result = serve.main(argv + ["--device", "cpu", "--batch", "2"])
    printed = json.loads(out.getvalue())
    assert REFERENCE_SERVE_KEYS <= set(printed) and result is None
    gen = int(argv[argv.index("--gen") + 1]) if "--gen" in argv else 16
    assert printed["generated_tokens"] == 2 * gen and printed["finite"]
    # on the CPU every wrapper takes its plain version: no kernel launches
    assert set(printed["launches"].values()) == {0}
    assert printed["peak_mem_gb"] is None


def test_entry_points_default_to_the_gpu():
    args = serve.build_parser().parse_args([])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError):
        serve.serve(args)
    with pytest.raises(RuntimeError):
        lm_params_from_jax({"w": np.zeros(2, np.float32)})



def _allocators():
    """The public state allocators of the serve and FL paths, each a
    function of ``**device`` returning its tensors."""
    cfg = configs.get_smoke_arch("jamba-1.5-large-398b")
    hybrid = dataclasses.replace(cfg, moe=None)
    return {
        "init_decode_state": lambda **d: jax.tree.leaves(
            transformer.init_decode_state(hybrid, 2, 8, **d)),
        "init_cache": lambda **d: list(
            attention.init_cache(cfg, 2, 8, **d).values()),
        "init_state": lambda **d: list(ssm.init_state(cfg, 2, **d).values()),
        "sketch_projection": lambda **d: [
            detection.sketch_projection(40, 8, **d)],
    }


ALLOCATORS = ["init_decode_state", "init_cache", "init_state",
              "sketch_projection"]


@pytest.mark.parametrize("name", ALLOCATORS)
def test_state_allocators_give_cpu_tensors_when_asked(name):
    tensors = _allocators()[name](device="cpu")
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", ALLOCATORS)
def test_state_allocators_default_to_the_gpu(name):
    """No device given means the card: without one it raises rather than
    handing back CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        _allocators()[name]()


@pytest.mark.parametrize("arch,changes", [
    ("jamba-1.5-large-398b", {}),                  # MoE
    ("deepseek-v2-236b", {"moe": None}),           # MLA
    ("xlstm-125m", {}),                            # mLSTM / sLSTM
    ("paligemma-3b", {}),                          # VLM patch prefix
    ("hubert-xlarge", {}),                         # audio frontend
])
def test_unported_parts_raise_not_implemented(arch, changes):
    cfg = dataclasses.replace(configs.get_smoke_arch(arch), **changes)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        transformer.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_decode_state(cfg, 1, 4, device="cpu")
