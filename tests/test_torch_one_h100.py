"""Every arch's one-H100 configuration (``configs/<arch>.py``'s
``ONE_H100``) against the JAX package's published ``CONFIG``, and kimi's
cut routing against the JAX package.

- Each arch's ``ONE_H100`` equals the reference's ``CONFIG`` field for
  field except the keys its docstring lists (``name`` aside), and the
  docstring states its ``param_count()`` (to the docstring's precision,
  within 1 %). Only kimi-k2's cut takes a width (``moe.n_experts`` 384 ->
  192).
- kimi's MoE at the cut's routing (192 experts, top-8, 1 shared expert)
  at a narrow d_model: ``moe_apply`` against the reference's on the same
  weights (``weights.lm_params_from_jax``), output and aux loss at rtol /
  atol 1e-5 (unit-scale activations, the same fp32 ops summed in another
  order), and the same choices dropped.
"""
import dataclasses
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

from torch_threads import one_torch_thread  # noqa: F401,E402 (fixture)

RTOL = ATOL = 1e-5
# the keys each cut changes (beyond its name) and its param_count()
CUTS = {
    "xlstm-125m": ((), 204_743_424),
    "qwen3-32b": (("n_layers",), 2_531_025_920),
    "nemotron-4-15b": (("n_layers",), 9_387_055_104),
    "jamba-1.5-large-398b": (("n_layers", "moe"), 8_998_920_192),
    "paligemma-3b": ((), 2_508_662_784),
    "hubert-xlarge": ((), 945_132_800),
    "phi4-mini-3.8b": (("n_layers",), 815_938_560),
    "kimi-k2-1t-a32b": (("n_layers", "moe"), 11_125_230_592),
    "minicpm-2b": ((), 2_724_880_896),
    "deepseek-v2-236b": (("n_layers",), 13_137_753_088),
}


def _docstring(arch):
    """The text after ``ONE_H100 =`` in the arch's config module."""
    src = inspect.getsource(base._arch_module(arch))
    return src[src.index("ONE_H100 ="):]


@pytest.mark.parametrize("arch", configs.arch_ids())
def test_one_h100_is_the_published_config_but_its_listed_cuts(arch):
    assert set(CUTS) == set(configs.arch_ids())
    changed, count = CUTS[arch]
    cut = configs.get_one_h100_arch(arch)
    full = dataclasses.asdict(jconfigs.get_arch(arch))
    got = dataclasses.asdict(cut)
    diff = {k for k in full if full[k] != got[k]} - {"name"}
    assert diff == set(changed)
    assert cut.param_count() == count
    text = _docstring(arch)
    for key in changed:
        assert f"``{key}" in text   # ``moe`` or ``moe.n_experts``
    stated = [float(x) for x in re.findall(r"([\d.]+) G parameters", text)]
    assert any(abs(x * 1e9 / count - 1) < 0.01 for x in stated), stated
    if changed:
        assert cut.name == f"{cut.name.split('-1xh100')[0]}-1xh100"


def test_kimi_cut_halves_the_experts_alone():
    cut = configs.get_one_h100_arch("kimi-k2-1t-a32b")
    full = jconfigs.get_arch("kimi-k2-1t-a32b")
    assert dataclasses.asdict(cut.moe) == {**dataclasses.asdict(full.moe),
                                           "n_experts": 192}
    assert (cut.n_layers, cut.n_dense_prefix) == (2, 1)
    # the published experts at two layers would not fit the card
    assert dataclasses.replace(cut, moe=dataclasses.replace(
        cut.moe, n_experts=384)).param_count() * 4 > 78e9


@pytest.mark.parametrize("n_tokens", [48, 192])
def test_kimi_cut_routing_matches_the_reference(n_tokens):
    """192 experts, top-8, 1 shared, at kimi smoke's d_model 128: 48
    tokens fill fewer slots than the capacity's floor, 192 (8 choices an
    expert on average) overflow some experts' capacity."""
    cfgs = []
    for c in (jconfigs.get_smoke_arch("kimi-k2-1t-a32b"),
              configs.get_smoke_arch("kimi-k2-1t-a32b")):
        cfgs.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_experts=192, top_k=8, n_shared=1)))
    jcfg, cfg = cfgs
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jp = jmoe.init_moe(jax.random.key(4), jcfg)
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(9).normal(
        size=(2, n_tokens // 2, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    drops = []
    out, aux = moe.moe_apply(p, cfg, torch.from_numpy(x), drops)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    (assignments, dropped), = drops
    assert assignments == n_tokens * 8
    # the reference's router logits routed by both: the same 8 experts
    logits = jnp.asarray(x.reshape(-1, cfg.d_model)) @ jp["router"]
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 8)
    r = moe.route(torch.tensor(np.asarray(logits)), cfg)
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(jidx))
    mine = moe.route(torch.from_numpy(x.reshape(-1, cfg.d_model))
                     @ p["router"], cfg)
    assert int(dropped) == int((~mine.keeps).sum())
    if n_tokens == 192:
        assert int(dropped) > 0
