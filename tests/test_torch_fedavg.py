"""The port's FedAvg mix and digest/divergence sweep against the JAX
package, on the CPU (plain versions).

Tolerance: fp32 sums taken in another order. The mix and the residuals
hold to rtol 1e-5 (the reference's tests/equivalence.py tier); a leaf sum
is held to 1e-6 of sum|x|, since cancellation makes its relative error
unbounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.kernels.fedavg.kernel import digest_div_flat as jdigest_div_flat
from repro.kernels.fedavg.kernel import fedavg_flat as jfedavg_flat
from repro.kernels.fedavg.ref import fedavg_flat_ref as jfedavg_flat_ref
from repro_torch.core import aggregation, mining
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import digest_div_flat_ref

RTOL, ATOL = 1e-5, 1e-6
# the MLP's leaf widths at hidden 32 plus a width the 2048-column Pallas
# tile does not divide (the main path's 784-256-10 widths are 256, 10,
# 200704 and 2560)
WIDTHS = [32, 10, 784 * 32, 320, 3000]


def _x(c, n, seed):
    return np.random.default_rng(seed).normal(size=(c, n)).astype(np.float32)


def _weights(c, uniform):
    if uniform:
        return np.full(c, 1.0 / c, np.float32)
    w = np.random.default_rng(c).uniform(0.5, 2.0, c).astype(np.float32)
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "weighted"])
@pytest.mark.parametrize("with_noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("n", WIDTHS)
def test_fedavg_flat_matches_pallas_kernel(n, with_noise, uniform):
    c = 5
    x, w = _x(c, n, n), _weights(c, uniform)
    noise = _x(c, n, n + 1) * 0.1 if with_noise else None
    want = np.asarray(jfedavg_flat(
        jnp.asarray(x), jnp.asarray(w),
        None if noise is None else jnp.asarray(noise), interpret=True))
    got = fedavg_ops.fedavg_flat(
        torch.from_numpy(x), torch.from_numpy(w),
        None if noise is None else torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = np.asarray(jfedavg_flat_ref(
        jnp.asarray(x), jnp.asarray(w),
        None if noise is None else jnp.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


# client counts of the sweep: 6, and either side of the CUDA kernel's
# register-form buckets and of its largest (32; above it the slab form)
DIGEST_CLIENTS = [1, 6, 7, 20, 33, 64]


@pytest.mark.parametrize("c", DIGEST_CLIENTS)
@pytest.mark.parametrize("n", WIDTHS)
def test_digest_div_flat_matches_pallas_kernel(n, c):
    x = _x(c, n, 10 + n + c) + 0.25
    js, jr = jdigest_div_flat(jnp.asarray(x), interpret=True)
    s, r = fedavg_ops.digest_div_flat(torch.from_numpy(x))
    assert s.shape == () and r.shape == (c,)
    np.testing.assert_allclose(float(s), float(js), rtol=0,
                               atol=1e-6 * np.abs(x).sum())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=RTOL)



def test_digest_div_flat_ref_takes_the_kernels_column_mean():
    """The plain version's column mean is the CUDA kernel's: the column
    summed in ascending c, then divided by C. At N = 1 each residual is one
    rounded square, so it is exactly (x - that mean)^2."""
    x = torch.from_numpy(_x(64, 1, 3) + 0.25)
    colsum = torch.zeros(1)
    for c in range(64):
        colsum = colsum + x[c]
    _, r = digest_div_flat_ref(x)
    assert torch.equal(r, ((x - colsum / 64) ** 2)[:, 0])


def _tree(c, seed, hidden=32):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (784, hidden), "b1": (hidden,), "w2": (hidden, 10),
              "b2": (10,)}
    return {k: rng.normal(size=(c,) + s).astype(np.float32)
            for k, s in shapes.items()}


def test_fedavg_tree_matches_aggregation_fedavg():
    tree = _tree(4, 0)
    want = jagg.fedavg({k: jnp.asarray(v) for k, v in tree.items()})
    got = aggregation.fedavg({k: torch.from_numpy(v) for k, v in tree.items()})
    assert sorted(got) == sorted(tree)
    for k in tree:
        assert got[k].shape == tree[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


def test_weighted_fedavg_tree_matches_aggregation_fedavg():
    tree = _tree(4, 1)
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    want = jagg.fedavg({k: jnp.asarray(v) for k, v in tree.items()},
                       jnp.asarray(w))
    got = aggregation.fedavg({k: torch.from_numpy(v) for k, v in tree.items()},
                             torch.from_numpy(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_once_matches_reference(weighted):
    tree = _tree(4, 5, hidden=8)
    w = np.array([3.0, 1.0, 2.0, 2.0], np.float32) if weighted else None
    want = jagg.aggregate_once({k: jnp.asarray(v) for k, v in tree.items()},
                               None if w is None else jnp.asarray(w))
    got = aggregation.aggregate_once(
        {k: torch.from_numpy(v) for k, v in tree.items()},
        None if w is None else torch.from_numpy(w))
    for k in tree:
        assert got[k].shape == tree[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


def test_replicate_gives_each_client_its_own_copy():
    single = {k: torch.from_numpy(v[0]) for k, v in _tree(1, 6, 8).items()}
    stacked = aggregation.replicate(single, 3)
    for k, v in stacked.items():
        assert v.shape == (3,) + single[k].shape
        assert torch.equal(v[2], single[k])
    stacked["w1"][0].add_(1.0)
    assert torch.equal(stacked["w1"][1], single["w1"])


def test_fedavg_tree_noise_is_added_per_row():
    tree = _tree(3, 2, hidden=8)
    noise = _tree(3, 3, hidden=8)
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    nz = {k: torch.from_numpy(v) for k, v in noise.items()}
    got = fedavg_ops.fedavg_tree(t, noise_tree=nz)
    base = fedavg_ops.fedavg_tree(t)
    for k in tree:
        np.testing.assert_allclose((got[k] - base[k]).numpy(), noise[k],
                                   rtol=RTOL, atol=ATOL)


def test_digest_divergence_tree_matches_client_divergence_and_digest_sums():
    tree = _tree(5, 4)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    digest, div = fedavg_ops.digest_divergence_tree(tt)
    np.testing.assert_allclose(float(div), float(jagg.client_divergence(jt)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(aggregation.client_divergence(tt)),
                               float(div), rtol=RTOL)
    # the digest folds the port's own leaf sums in sorted key order; each
    # of those sums is the reference digest_tree's jnp.sum to tolerance
    acc = mining.as_word(mining.DIGEST_INIT)
    for k in sorted(tree):
        s, _ = digest_div_flat_ref(tt[k].reshape(5, -1))
        np.testing.assert_allclose(float(s), float(jnp.sum(jt[k])), rtol=0,
                                   atol=1e-6 * np.abs(tree[k]).sum())
        acc = mining.fold_digest(acc, s)
    assert int(acc) == int(digest)
    # the port's digest_tree (whole-leaf torch sums) folds the same bits
    assert int(mining.digest_tree(tt)) == int(digest)


def test_wrappers_validate_inputs():
    x = torch.zeros((3, 4))
    w = torch.full((3,), 1 / 3)
    with pytest.raises(TypeError):
        fedavg_ops.fedavg_flat(x.double(), w)
    with pytest.raises(TypeError):
        fedavg_ops.fedavg_flat(x, w[:2])
    with pytest.raises(TypeError):
        fedavg_ops.fedavg_flat(x, w, torch.zeros((3, 5)))
    with pytest.raises(TypeError):
        fedavg_ops.digest_div_flat(x.t())          # not contiguous
    with pytest.raises(ValueError):
        fedavg_ops.digest_div_flat(x.to("meta"))   # neither cuda nor cpu
    with pytest.raises(TypeError):
        fedavg_ops.digest_divergence_tree({"n": torch.zeros((3, 2),
                                                            dtype=torch.int64)})
