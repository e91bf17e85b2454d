"""The port's mix_rows_flat kernel (its plain version here) and its
single-device mixes against the JAX package, on the CPU.

Tolerance: fp32 contractions taken in another order. Every mix holds to
rtol 1e-5 / atol 1e-6 (the reference's tests/equivalence.py tier).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.core import rounds as jrounds
from repro.core import topology as jtopology
from repro.kernels.fedavg import ops as jfedavg_ops
from repro.kernels.fedavg.kernel import mix_rows_flat as jmix_rows_flat
from repro_torch import kernels
from repro_torch.core import aggregation, rounds, topology
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import mix_rows_flat_ref

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 1e-5, 1e-6


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _stochastic(r, k, seed):
    w = np.random.default_rng(seed).uniform(0.1, 1.0, (r, k))
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _tree(c, seed, hidden=32):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (784, hidden), "b1": (hidden,), "w2": (hidden, 10),
              "b2": (10,)}
    return {k: rng.normal(size=(c,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# (R, K, N): square, a row block (R < K), a column block (R > K), the
# largest block whose w_rows the kernel stages at once, and widths the
# 2048-column Pallas tile does not divide
MIX_CASES = [(4, 4, 3000), (20, 20, 2560), (5, 20, 2049), (20, 5, 10),
             (64, 64, 4100), (1, 3, 7), (8, 2, 200)]


@pytest.mark.parametrize("r,k,n", MIX_CASES)
def test_mix_rows_flat_plain_version_matches_pallas_kernel(r, k, n):
    w, x = _stochastic(r, k, r * k), _x((k, n), n)
    want = np.asarray(jmix_rows_flat(jnp.asarray(w), jnp.asarray(x),
                                     interpret=True))
    got = mix_rows_flat_ref(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the kernel's arithmetic, term for term: from zero, add each rounded
    # product in ascending k (the CUDA kernel is held to these bits)
    acc = np.zeros((r, n), np.float32)
    for kk in range(k):
        acc = acc + w[:, kk:kk + 1] * x[kk:kk + 1]
    np.testing.assert_array_equal(got.numpy(), acc)
    # the wrapper takes the plain version for CPU tensors, uncounted
    kernels.reset_launch_counts()
    wrapped = fedavg_ops.mix_rows_flat(torch.from_numpy(w),
                                       torch.from_numpy(x))
    assert torch.equal(wrapped, got)
    assert kernels.launch_counts()["mix_rows_flat"] == 0


@pytest.mark.parametrize("r", [65, 100, 200])
@pytest.mark.parametrize("k", [65, 100, 200])
def test_mix_rows_flat_past_64_clients_matches_pallas_kernel(r, k):
    """R and K past the 64 the kernel's shared-memory stage holds at once:
    the wrapper takes them (the kernel restages w_rows every 64 k), bitwise
    equal to the rounded products added in ascending k, and within the
    reference's tolerance of the JAX kernel."""
    n = 515
    w, x = _stochastic(r, k, r + k), _x((k, n), r * k)
    want = np.asarray(jmix_rows_flat(jnp.asarray(w), jnp.asarray(x),
                                     interpret=True))
    got = fedavg_ops.mix_rows_flat(torch.from_numpy(w), torch.from_numpy(x))
    assert torch.equal(got, mix_rows_flat_ref(torch.from_numpy(w),
                                              torch.from_numpy(x)))
    acc = np.zeros((r, n), np.float32)
    for kk in range(k):
        acc = acc + w[:, kk:kk + 1] * x[kk:kk + 1]
    np.testing.assert_array_equal(got.numpy(), acc)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mix_rows_tree_matches_reference_tree():
    tree = _tree(6, 0)
    w = _stochastic(3, 6, 1)   # a row block of a 6-client W
    want = jfedavg_ops.mix_rows_tree(_jt(tree), jnp.asarray(w),
                                     interpret=True)
    _close(fedavg_ops.mix_rows_tree(_tt(tree), torch.from_numpy(w)), want)


def test_mix_rows_flat_validates_inputs():
    x = torch.zeros((4, 5))
    w = torch.full((4, 4), 0.25)
    with pytest.raises(TypeError):
        fedavg_ops.mix_rows_flat(w.double(), x)
    with pytest.raises(TypeError):
        fedavg_ops.mix_rows_flat(w[:, :3].contiguous(), x)   # K mismatch
    with pytest.raises(TypeError):
        fedavg_ops.mix_rows_flat(w.t(), x.t().contiguous()[:4])
    with pytest.raises(ValueError, match="row blocks"):   # past the grid
        fedavg_ops.mix_rows_flat(
            torch.zeros((fedavg_ops.MIX_MAX_ROWS + 1, 1)), torch.zeros((1, 3)))
    # meta tensors take the dry-run's branch (the output's shape, no
    # launch); a device that is neither cpu, cuda nor meta raises
    out = fedavg_ops.mix_rows_flat(w.to("meta"), x.to("meta"))
    assert out.device.type == "meta" and out.shape == (4, 5)

    class Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")

    with pytest.raises(ValueError):
        fedavg_ops.mix_rows_flat(w, x.as_subclass(Elsewhere))
    assert "mix_rows_flat" in kernels.WRAPPERS


@pytest.mark.parametrize("weighted", [False, True])
def test_mix_and_reweight_rows_match_reference(weighted):
    tree = _tree(5, 2)
    w = _stochastic(5, 5, 3)
    dw = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32) if weighted else None
    jdw = None if dw is None else jnp.asarray(dw)
    tdw = None if dw is None else torch.from_numpy(dw)
    np.testing.assert_allclose(
        aggregation._reweight_rows(torch.from_numpy(w), tdw).numpy(),
        np.asarray(jagg._reweight_rows(jnp.asarray(w), jdw)), rtol=1e-6)
    want = jagg.mix(_jt(tree), jnp.asarray(w), jdw)
    _close(aggregation.mix(_tt(tree), torch.from_numpy(w), tdw), want)
    for use_kernel in (False, True):
        jgot = jagg.mix_gather(_jt(tree), jnp.asarray(w), jdw,
                               use_kernel=use_kernel, interpret=True)
        _close(aggregation.mix_gather(_tt(tree), torch.from_numpy(w), tdw,
                                      use_kernel=use_kernel), jgot)
    _close(aggregation.mix_all_reduce(_tt(tree), tdw),
           jagg.mix_all_reduce(_jt(tree), jdw))


@pytest.mark.parametrize("offsets,weight", [((-1, 0, 1), 1 / 3),
                                            ((-2, -1, 0, 1, 2), 0.2),
                                            ((0, 3), 0.5), ((0, 9), 0.5)])
def test_mix_rolls_and_halo_aliases_match_reference(offsets, weight):
    # mix_rolls is the port's one-device form of both halo mixes
    tree = _tree(6, 4)
    got = aggregation.mix_rolls(_tt(tree), offsets, weight)
    _close(got, jagg.mix_rolls(_jt(tree), offsets, weight))
    _close(got, jagg.mix_neighbor_halo(_jt(tree), offsets, weight, None))
    _close(got, jagg.mix_shift_halo(_jt(tree), offsets, weight, None))


@pytest.mark.parametrize("name", ["partial:3", "ring:2", "snr:4"])
def test_mix_segment_matches_reference(name):
    c = 8
    jt = jtopology.from_name(name)
    sp = jtopology.sparse_from_dense(np.asarray(jt.matrix(c)))
    tree = _tree(c, 5)
    want = jax.jit(jagg.mix_segment)(_jt(tree), sp.neighbor_idx, sp.edge_w)
    got = aggregation.mix_segment(_tt(tree),
                                  torch.from_numpy(sp.neighbor_idx),
                                  torch.from_numpy(sp.edge_w))
    _close(got, want)
    # and it is the dense mix of the same matrix
    _close(got, jagg.mix(_jt(tree), jt.matrix(c)))


@pytest.mark.parametrize("g,alpha", [(2, 0.3), (4, 0.5), (1, 0.3), (8, 0.0)])
def test_mix_cluster_matches_reference(g, alpha):
    tree = _tree(8, 6)
    want = jax.jit(lambda t: jagg.mix_cluster(t, g, alpha))(_jt(tree))
    got = aggregation.mix_cluster(_tt(tree), g, alpha)
    _close(got, want)
    _close(got, jagg.mix(_jt(tree), topology.ClusterTopology(g, alpha)
                         .matrix(8)))


def _stage_inputs(c, seed):
    post = _tree(c, seed)
    prev = {k: v + 0.01 * _x(v.shape, seed + 1) for k, v in post.items()}
    return post, prev


@pytest.mark.parametrize("name,fused,dw", [
    ("full", False, False), ("full", False, True), ("ring", False, False),
    ("ring:4", False, False), ("shift:5", False, False),
    ("rotate", False, False), ("cluster:2", False, False),
    ("partial:1", False, False), ("random:0.5", True, False),
    ("random:0.5", False, True), ("snr", True, True), ("alt", False, False)])
def test_communicate_stage_matches_reference(name, fused, dw):
    """One communicate call per executor mode at round 3, the reference's
    W injected: same mix and divergence; the digest is the one-sweep digest
    of the broadcast set, before the mix."""
    c = 8
    jt, t = jtopology.from_name(name), topology.from_name(name)
    weights = tuple(float(i % 3 + 1) for i in range(c)) if dw else None
    common = dict(n_clients=c, tau=1, eta=0.1, fused_mix=fused,
                  data_weights=weights)
    jspec = jrounds.RoundSpec(topology=jt, kernel_interpret=True, **common)
    spec = rounds.RoundSpec(topology=t, **common)
    post, prev = _stage_inputs(c, 7)
    k_topo = jax.random.key(11) if jt.stochastic else None
    want, _, jdiv, _ = jax.jit(jrounds.make_communicate(jspec))(
        _jt(post), _jt(prev), k_topo, jnp.int32(3))
    w = torch.from_numpy(np.array(jt.matrix(c, key=k_topo, round_idx=3)))
    communicate = rounds.make_communicate(spec, "cpu")
    assert communicate.plan.mode == jtopology.resolve_mix_plan(jspec).mode
    got, digest, div, extra = communicate(_tt(post), _tt(prev), 3, w)
    _close(got, want)
    np.testing.assert_allclose(float(div), float(jdiv), rtol=RTOL)
    assert extra == {}
    assert int(digest) == int(fedavg_ops.digest_divergence_tree(
        _tt(post))[0])


def test_gather_mode_needs_the_round_matrix():
    spec = rounds.RoundSpec(n_clients=4, tau=1, eta=0.1,
                            topology=topology.from_name("random:0.5"))
    with pytest.raises(ValueError, match="matrix"):
        rounds.make_communicate(spec, "cpu")(_tt(_tree(4, 0)),
                                             _tt(_tree(4, 1)), 0)
    assert rounds.mix_matrices(rounds.RoundSpec(n_clients=4, tau=1, eta=0.1),
                               3, device="cpu") is None
    with pytest.raises(ValueError, match="topology_matrices"):
        rounds.mix_matrices(spec, 3, device="cpu",
                            topology_matrices=np.zeros((2, 4, 4)))
