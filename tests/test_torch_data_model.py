"""The port's data, MLP, configuration and analysis copies against the JAX
package, on the CPU.

``dirichlet_partition`` is numpy-seeded, so it must match bitwise. The MLP
runs on the reference's own weights (``params_from_jax``): loss within
rtol 1e-5 and gradients within rtol 1e-4 / atol 1e-6, the room fp32
matmuls and batch reductions in another order need.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import BladeConfig as JBladeConfig
from repro.core import allocation as jallocation
from repro.core import bounds as jbounds
from repro.core import lazy as jlazy
from repro.data import synthetic as jsynthetic
from repro.models import layers as jlayers
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch import resolve_device
from repro_torch.configs import BladeConfig
from repro_torch.core import allocation, bounds, lazy
from repro_torch.data import synthetic
from repro_torch.data.pipeline import FLDataSource
from repro_torch.models import layers
from repro_torch.models.mlp import (init_mlp, mlp_client_losses, mlp_logits,
                                    mlp_loss)
from repro_torch.weights import batch_from_numpy, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("n_clients,alpha,m,seed",
                         [(4, 0.5, 16, 0), (20, 0.1, 64, 3), (7, 10.0, 33, 9)])
def test_dirichlet_partition_bitwise(n_clients, alpha, m, seed):
    y = np.random.default_rng(seed).integers(0, 10, 500)
    want = jsynthetic.dirichlet_partition(y, n_clients, alpha, m, seed=seed)
    got = synthetic.dirichlet_partition(y, n_clients, alpha, m, seed=seed)
    np.testing.assert_array_equal(got, want)


def _jax_params(hidden, seed=0):
    p = jinit_mlp(jax.random.key(seed), hidden=hidden)
    return {k: np.asarray(v) for k, v in p.items()}


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 1, shape + (784,)).astype(np.float32),
            "y": rng.integers(0, 10, shape).astype(np.int32)}


def test_mlp_loss_and_grad_on_reference_weights():
    npp, nb = _jax_params(32), _batch((24,), 1)
    (jl, jm), jg = jax.value_and_grad(jmlp_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in npp.items()},
        {k: jnp.asarray(v) for k, v in nb.items()})
    params = params_from_jax(npp, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    loss, metrics = mlp_loss(params, batch_from_numpy(nb, "cpu"))
    grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(jm["accuracy"])
    for k, g in zip(sorted(params), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)


def test_client_stacked_losses_and_grads_match_vmap():
    c = 3
    stacked = {k: np.stack([_jax_params(16, s)[k] for s in range(c)])
               for k in ("w1", "b1", "w2", "b2")}
    nb = _batch((c, 12), 2)
    jfn = jax.vmap(jax.value_and_grad(lambda p, b: jmlp_loss(p, b)[0]))
    jl, jg = jfn({k: jnp.asarray(v) for k, v in stacked.items()},
                 {k: jnp.asarray(v) for k, v in nb.items()})
    params = params_from_jax(stacked, "cpu")
    leaves = [params[k].requires_grad_(True) for k in sorted(params)]
    losses = mlp_client_losses(params, batch_from_numpy(nb, "cpu"))
    assert losses.shape == (c,)
    grads = torch.autograd.grad(losses.sum(), leaves)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jl),
                               rtol=1e-5)
    for k, g in zip(sorted(params), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)


def test_stacked_logits_equal_per_client_logits():
    gen = torch.Generator().manual_seed(0)
    ps = [init_mlp(gen, hidden=8) for _ in range(2)]
    stacked = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    x = torch.rand((2, 5, 784), generator=gen)
    got = mlp_logits(stacked, x)
    for i, p in enumerate(ps):
        torch.testing.assert_close(got[i], mlp_logits(p, x[i]), rtol=1e-5,
                                   atol=1e-6)


def test_softmax_cross_entropy_matches():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 9, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, (4, 9))
    got = layers.softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    for i in range(4):
        want = jlayers.softmax_cross_entropy(jnp.asarray(logits[i]),
                                             jnp.asarray(labels[i]))
        np.testing.assert_allclose(float(got[i]), float(want), rtol=1e-6)


def test_init_and_data_are_seeded_and_shaped():
    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return init_mlp(gen), synthetic.mnist_proxy(gen, 64)

    (p0, d0), (p1, d1), (p2, _) = make(0), make(0), make(1)
    assert {k: tuple(v.shape) for k, v in p0.items()} == {
        "w1": (784, 256), "b1": (256,), "w2": (256, 10), "b2": (10,)}
    assert torch.equal(p0["w1"], p1["w1"]) and torch.equal(d0["x"], d1["x"])
    assert not torch.equal(p0["w1"], p2["w1"])
    assert d0["x"].dtype == torch.float32 and d0["x"].shape == (64, 784)
    assert float(d0["x"].min()) > 0 and float(d0["x"].max()) < 1
    assert d0["y"].shape == (64,) and int(d0["y"].max()) < 10
    fashion = synthetic.fashion_proxy(torch.Generator().manual_seed(0), 8)
    assert fashion["x"].shape == (8, 784)


def test_fl_data_source_partitions_like_the_reference():
    src = FLDataSource(torch.Generator().manual_seed(0), 4, 16, 0.5, seed=3,
                       device="cpu")
    x, y = src.static_batch()["x"], src.static_batch()["y"]
    assert x.shape == (4, 16, 784) and y.shape == (4, 16)
    assert src.eval_data["x"].shape == (2048, 784)
    part = jsynthetic.dirichlet_partition(src.data["y"].numpy(), 4, 0.5, 16,
                                          seed=3)
    np.testing.assert_array_equal(y.numpy(), src.data["y"].numpy()[part])
    assert src.round_batch(7) is src.static_batch()


def test_weights_round_trip_and_validation():
    npp = _jax_params(8)
    back = params_from_jax(npp, "cpu")
    for k in npp:
        assert back[k].dtype == torch.float32 and back[k].is_contiguous()
        np.testing.assert_array_equal(back[k].numpy(), npp[k])
    with pytest.raises(TypeError):
        params_from_jax({"w": np.zeros(3, np.int32)}, "cpu")
    b = batch_from_numpy({"x": np.zeros((2, 3), np.float64),
                          "y": np.zeros(2, np.int32)}, "cpu")
    assert b["x"].dtype == torch.float32 and b["y"].dtype == torch.int64


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_allocation_and_config_copies_agree():
    for t_sum, k, a, b in [(100, 5, 1, 10), (100, 7, 1.5, 3), (10, 2, 1, 20)]:
        assert allocation.tau_from_budget(t_sum, k, a, b) == \
            jallocation.tau_from_budget(t_sum, k, a, b)
        assert allocation.feasible_rounds(t_sum, a, b) == \
            jallocation.feasible_rounds(t_sum, a, b)
    assert allocation.mining_iterations(10) == \
        jallocation.mining_iterations(10) == 10240
    assert BladeConfig().tau == JBladeConfig().tau == 10
    p = dict(eta=0.05, L=2.0, xi=1.0, delta=0.5, alpha=1.0, beta=10.0,
             t_sum=100.0)
    port, ref = bounds.BoundParams(**p), jbounds.BoundParams(**p)
    for k in (2, 5, 9):
        assert bounds.g_of_k(port, k) == jbounds.g_of_k(ref, k)
    assert bounds.k_star_numeric(port) == jbounds.k_star_numeric(ref)
    assert allocation.optimal_plan(port).K == jallocation.optimal_plan(ref).K


@pytest.mark.parametrize("n_clients,n_lazy", [(5, 2), (4, 3), (20, 2)])
def test_plagiarism_sources_agree(n_clients, n_lazy):
    np.testing.assert_array_equal(lazy.plagiarism_sources(n_clients, n_lazy),
                                  jlazy.plagiarism_sources(n_clients, n_lazy))
    with pytest.raises(ValueError):
        lazy.plagiarism_sources(n_clients, n_clients)
