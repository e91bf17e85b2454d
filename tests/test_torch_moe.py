"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py`` on the CPU, with the reference's params
carried across by ``weights.lm_params_from_jax``.

The routing is held bitwise: the reference's ``moe_apply`` is run equation
by equation from its jaxpr, and its router logits, the experts its
``top_k`` picks, its stacked slots and keeps and its dispatch buffer's
capacity are read off; the port's ``route`` gets those logits and must
give the same integers. Planted exact ties (equal router columns, a zero
token) must go to the lower expert index, as ``jax.lax.top_k`` sends
them, and a cohort of like tokens must overflow the capacity.

Tolerance: rtol / atol 1e-5 on ``moe_apply``'s output and aux loss (unit-
scale activations; the same fp32 ops summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.weights import lm_params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL = ATOL = 1e-5
MOE_ARCHS = ["jamba-1.5-large-398b", "kimi-k2-1t-a32b", "deepseek-v2-236b"]
MLP_KINDS = ["swiglu", "geglu", "squared_relu", "gelu"]


def _pair(arch, **moe_changes):
    """(reference, port) smoke configs of a MoE arch, ``moe_changes``
    applied to the MoE config of both (``mlp`` moves the expert FFN's
    kind); equal field for field."""
    mlp = moe_changes.pop("mlp", None)
    out = []
    for cfg in (jconfigs.get_smoke_arch(arch), configs.get_smoke_arch(arch)):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes),
            mlp=mlp or cfg.mlp)
        out.append(cfg)
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _reference_routing(jparams, jcfg, x):
    """The reference's routing of x [B, S, D], read from its ``moe_apply``
    run equation by equation: (router logits [T, E], gate_idx, slots,
    keeps, capacity) as numpy."""
    closed = jax.make_jaxpr(lambda v: jmoe.moe_apply(jparams, jcfg, v))(x)
    eqns = closed.jaxpr.eqns
    by_name = {}
    for e in eqns:
        by_name.setdefault(e.primitive.name, []).append(e)
    logits = by_name["dot_general"][0].outvars[0]
    gate_idx = by_name["top_k"][0].outvars[1]
    t, k = gate_idx.aval.shape
    stacked = [e.outvars[0] for e in by_name["concatenate"]
               if e.outvars[0].aval.shape == (t, k)]
    slots = next(v for v in stacked if v.aval.dtype == jnp.int32)
    keeps = next(v for v in stacked if v.aval.dtype == jnp.bool_)
    capacity = by_name["scatter"][0].invars[0].aval.shape[1] - 1
    wanted = closed.jaxpr.replace(outvars=[logits, gate_idx, slots, keeps])
    vals = jax.core.eval_jaxpr(wanted, closed.consts, x)
    return [np.asarray(v) for v in vals] + [capacity]


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(case, d, rng):
    """[B, S, D] inputs: random, with a zero token (every logit 0, a tie
    of all experts), or a cohort of like tokens that overflows the
    capacity."""
    if case == "like":
        base = rng.normal(size=d)
        return (base + 0.01 * rng.normal(size=(1, 24, d))).astype(np.float32)
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    if case == "ties":
        x[0, 3] = 0.0
    return x


@pytest.mark.parametrize("case", ["random", "ties", "like"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_is_the_reference_routing_bitwise(arch, case):
    jcfg, cfg = _pair(arch)
    jp, _ = _params(jcfg)
    if case == "ties":   # experts 1 and 2 tie for every token
        jp["router"] = jp["router"].at[:, 2].set(jp["router"][:, 1])
    rng = np.random.default_rng(7)
    x = jnp.asarray(_tokens(case, cfg.d_model, rng))
    logits, gate_idx, slots, keeps, capacity = _reference_routing(jp, jcfg, x)
    r = moe.route(torch.tensor(logits), cfg)
    assert r.capacity == capacity == moe.capacity_of(cfg, logits.shape[0])
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.slots.numpy(), slots)
    np.testing.assert_array_equal(r.keeps.numpy(), keeps)
    if case == "ties":
        tied = np.flatnonzero(logits[:, 1] == logits[:, 2])
        assert len(tied) == logits.shape[0]
        # the zero token: every prob equal, so the lowest experts
        np.testing.assert_array_equal(gate_idx[3], np.arange(cfg.moe.top_k))
        # expert 2 only beside expert 1, which ties with it and ranks first
        picked1, picked2 = ((gate_idx == e).any(1) for e in (1, 2))
        assert picked1.any() and (picked1 | ~picked2).all()
    if case == "like":
        assert not keeps.all()       # the capacity dropped choices
        assert (slots[~keeps] == capacity).all()


@pytest.mark.parametrize("kind", MLP_KINDS)
@pytest.mark.parametrize("n_shared,capacity_factor",
                         [(0, 1.25), (1, 1.25), (1, 0.5)])
def test_moe_apply_matches_reference(kind, n_shared, capacity_factor):
    """kimi's smoke MoE with each expert FFN kind, with and without a
    shared expert; at capacity factor 0.5 the capacity (4 slots an expert
    for 36 choices over 4 experts) drops choices."""
    jcfg, cfg = _pair("kimi-k2-1t-a32b", mlp=kind, n_shared=n_shared,
                      capacity_factor=capacity_factor)
    jp, p = _params(jcfg, seed=3)
    assert ("shared" in p) == bool(n_shared)
    assert ("w_gate" in p) == (kind in ("swiglu", "geglu"))
    x = np.random.default_rng(8).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    drops = []
    out, aux = moe.moe_apply(p, cfg, torch.from_numpy(x), drops)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    (assignments, dropped), = drops
    _, _, _, keeps, _ = _reference_routing(jp, jcfg, jnp.asarray(x))
    assert assignments == keeps.size and int(dropped) == (~keeps).sum()
    if capacity_factor < 1:
        assert int(dropped) > 0


def test_decode_shape_runs_every_expert():
    """Decode's [B, 1, D] at B = 4: T = 4 gives the capacity floor 4, so
    no choice is dropped, and a token's output does not depend on the
    other tokens of its step."""
    _, cfg = _pair("deepseek-v2-236b")
    _, p = _params(_pair("deepseek-v2-236b")[0], seed=5)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 1, cfg.d_model)).astype(np.float32))
    assert moe.capacity_of(cfg, 4) == 4
    drops = []
    out, _ = moe.moe_apply(p, cfg, x, drops)
    assert int(drops[0][1]) == 0
    alone, _ = moe.moe_apply(p, cfg, x[1:2])
    np.testing.assert_allclose(out[1:2].numpy(), alone.numpy(), rtol=RTOL,
                               atol=ATOL)
