"""The port's client-sharding layer on the CPU: the carry plans and the mix
resolver against the JAX package's, and each client-sharded mix over gloo
ranks against the port's one-device form.

The plans and the resolver are host logic, held field by field (and error
text for error text) to ``repro.sharding.plans`` and
``repro.core.topology.resolve_mix_plan`` over the topology x flag grid of
``tests/test_hierarchy.py`` on one device, a 4-way flat mesh and a 2 x 4
``("pod", "data")`` mesh. The mixes run at D = 2 and D = 4 (flat, and
2 x 2 for the cluster layout) in one world each: the gather tier bitwise
the one-device mix, the psum tier within rtol 1e-5.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist
from repro.core import rounds as jrounds
from repro.core import topology as jtopology
from repro.sharding import plans as jplans
from repro_torch.core import aggregation, rounds, topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import plans

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

C = 8
PSUM_RTOL = 1e-5


def _mesh(shape, axes, backend="gloo"):
    """A rank's mesh record without a process group (host logic only)."""
    return mesh_lib.ClientMesh(axis_names=axes, shape=shape, rank=0,
                               backend=backend, device=torch.device("cpu"),
                               world=None, groups={})


@pytest.mark.parametrize("backend,device,driver", [
    ("gloo", "cuda", "loop"), ("nccl", "cuda", "graph"),
    ("gloo", "cpu", "loop")])
def test_dispatch_plan_captures_only_nccl_collectives(backend, device,
                                                      driver):
    """The graph driver needs collectives a CUDA graph can capture: on
    the card an NCCL mesh takes it, a gloo mesh runs the loop (its
    collectives go through the host). The mix is resolved on the mesh:
    PairShift(5)'s shift outgrows a 2-client block."""
    spec = rounds.RoundSpec(n_clients=C, tau=1, eta=0.1,
                            topology=topology.PairShift(shift=5))
    batch = {"x": torch.zeros(C // 4, 2, 3)}
    plan = rounds.dispatch_plan(spec, device, batch,
                                mesh=_mesh((4,), ("data",), backend))
    assert plan["driver"] == driver
    assert plan["mix_mode"] == topology.EXEC_SHIFT_HALO
    assert rounds.dispatch_plan(spec, device, batch)["mix_mode"] == \
        topology.EXEC_HALO


PLAN_CASES = [
    # (mesh shape, axes, clients, client_axes)
    ((4,), ("data",), 8, ("data",)),
    ((2, 4), ("pod", "data"), 16, ("pod", "data")),
    ((2, 4), ("pod", "data"), 8, ("data",)),
    ((4,), ("data",), 6, ("data",)),                  # not divisible
    ((2, 4), ("pod", "data"), 12, ("pod", "data")),   # not divisible
    ((4,), ("data",), 8, ()),                          # empty
    ((2, 4), ("pod", "data"), 8, ("data", "data")),   # duplicate
    ((4,), ("data",), 8, ("model",)),                  # no such axis
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("shape,axes,c,client_axes", PLAN_CASES)
def test_scan_carry_plan_matches_the_reference(shape, axes, c, client_axes):
    jmesh = SimpleNamespace(shape=dict(zip(axes, shape)))
    want = _outcome(lambda: jplans.scan_carry_plan(jmesh, c, client_axes))
    got = _outcome(lambda: plans.scan_carry_plan(_mesh(shape, axes), c,
                                                 client_axes))
    if isinstance(want, str):
        assert got == want
        return
    assert (got.n_clients, got.client_axes, got.n_shards, got.axis_sizes,
            got.clients_per_shard) == (
        want.n_clients, want.client_axes, want.n_shards, want.axis_sizes,
        want.clients_per_shard)
    blocks = [got.rows(i) for i in range(got.n_shards)]
    assert [r.start for r in blocks] == list(
        range(0, c, got.clients_per_shard))


@pytest.mark.parametrize("enrolled,cohort", [(64, 8), (10, 12), (64, 6),
                                             (64, 0)])
def test_cohort_carry_plan_matches_the_reference(enrolled, cohort):
    jmesh = SimpleNamespace(shape={"data": 4})
    want = _outcome(lambda: jplans.cohort_carry_plan(jmesh, enrolled,
                                                     cohort))
    got = _outcome(lambda: plans.cohort_carry_plan(_mesh((4,), ("data",)),
                                                   enrolled, cohort))
    if isinstance(want, str):
        assert got == want
        return
    assert (got.n_enrolled, got.cohort_size, got.n_shards,
            got.clients_per_shard) == (want.n_enrolled, want.cohort_size,
                                       want.n_shards, want.clients_per_shard)


@pytest.mark.parametrize("c,d", [(16, 4), (16, 1), (20, 4), (10, 4), (8, 0)])
def test_gathered_mix_models_moved_matches_the_reference(c, d):
    assert _outcome(lambda: plans.gathered_mix_models_moved(c, d)) == \
        _outcome(lambda: jplans.gathered_mix_models_moved(c, d))


# the grid of tests/test_hierarchy.py:29-55, in both packages
def _topologies(pkg):
    return [
        pkg.FullMesh(), pkg.Ring(neighbors=1), pkg.Ring(neighbors=2),
        pkg.RandomGraph(p_link=0.6), pkg.PartialParticipation(n_active=3),
        pkg.PairShift(shift=5), pkg.ClusterTopology(n_clusters=2),
        pkg.ClusterTopology(n_clusters=4, inter_weight=0.5),
        pkg.ExplicitSparse(neighbors=tuple((i, (i + 1) % C)
                                           for i in range(C))),
        pkg.GossipRotation(),
        pkg.AlternatingSchedule(((pkg.Ring(neighbors=1), 2),
                                 (pkg.FullMesh(), 1))),
        pkg.LinkQualitySchedule(fading_period=3),
    ]


FLAG_GRID = list(itertools.product(
    (False, True),                                   # fast_allreduce
    (False, True),                                   # fused_mix
    (None, True),                                    # sparse_mix
    (None, tuple(float(i + 1) for i in range(C))),   # data_weights
    (None, "median", "trimmed:2", "geomed:4"),       # robust_agg
))
MESH_AXES = [None, (("data", 4),), (("pod", 2), ("data", 4))]
PLAN_FIELDS = ("mode", "kind", "mix", "offsets", "weight", "offsets_table",
               "period", "n_shards", "fast_diagnostics", "use_kernel",
               "needs_matrix", "n_clusters", "inter_weight", "trim",
               "robust_iters")


def _resolved(resolve, spec, axes):
    try:
        return resolve(spec, axes)
    except ValueError as err:
        return str(err)


@pytest.mark.parametrize("i", range(len(_topologies(topology))),
                         ids=[type(t).__name__ + str(i) for i, t in
                              enumerate(_topologies(topology))])
def test_resolve_mix_plan_matches_the_reference_field_by_field(i):
    jtopo, topo = _topologies(jtopology)[i], _topologies(topology)[i]
    for fast, fused, sparse, weights, robust in FLAG_GRID:
        flags = dict(n_clients=C, tau=1, eta=0.1, mine_attempts=8,
                     difficulty_bits=1, fast_allreduce=fast,
                     fused_mix=fused, sparse_mix=sparse,
                     data_weights=weights, robust_agg=robust)
        jspec = jrounds.RoundSpec(topology=jtopo, **flags)
        spec = rounds.RoundSpec(topology=topo, **flags)
        for axes in MESH_AXES:
            want = _resolved(jtopology.resolve_mix_plan, jspec, axes)
            got = _resolved(topology.resolve_mix_plan, spec, axes)
            case = (type(topo).__name__, fast, fused, sparse,
                    weights is not None, robust, axes)
            if isinstance(want, str):
                assert got == want, case
                continue
            for field in PLAN_FIELDS:
                assert getattr(got, field) == getattr(want, field), \
                    (case, field)
            for field in ("weights", "psum_row"):
                w, g = getattr(want, field), getattr(got, field)
                assert (g is None) == (w is None), (case, field)
                if w is not None:
                    np.testing.assert_array_equal(g, np.asarray(w))
            assert (got.sparse is None) == (want.sparse is None), case
            if want.sparse is not None:
                np.testing.assert_array_equal(got.sparse.neighbor_idx,
                                              want.sparse.neighbor_idx)
                np.testing.assert_array_equal(got.sparse.edge_w,
                                              want.sparse.edge_w)


# ---------------------------------------------------------------------------
# Each sharded mix over gloo ranks against its one-device form
# ---------------------------------------------------------------------------

MIX_C = 8


def _tree(c=MIX_C, seed=11):
    rng = np.random.default_rng(seed)
    return {"m2": rng.standard_normal((c, 37)).astype(np.float32),
            "m3": rng.standard_normal((c, 5, 7)).astype(np.float32)}


def _w(seed=5):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, (MIX_C, MIX_C)).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


RING = (-1, 0, 1)
GATHER_MIXES = {
    # name: (aggregation function, its kwargs)
    "halo_ring1": ("mix_neighbor_halo", dict(offsets=RING, weight=1 / 3)),
    "shift_halo_pair5": ("mix_shift_halo", dict(offsets=(0, 5), weight=0.5)),
    "shift_halo_wrap": ("mix_shift_halo",
                        dict(offsets=(-3, 0, 2, 7), weight=0.25)),
    "all_reduce": ("mix_all_reduce", {}),
    "all_reduce_weighted": ("mix_all_reduce",
                            dict(weights=np.arange(1.0, 9.0,
                                                   dtype=np.float32))),
    "gather": ("mix_gather", dict(W=_w())),
    "gather_kernel": ("mix_gather", dict(W=_w(), use_kernel=True)),
    "segment": ("mix_segment", dict(
        neighbor_idx=np.array([[i, (i + 3) % MIX_C] for i in range(MIX_C)]),
        edge_w=np.full((MIX_C, 2), 0.5, np.float32))),
    "cluster": ("mix_cluster", dict(n_clusters=2, inter_weight=0.3)),
    "cluster_g4": ("mix_cluster", dict(n_clusters=4, inter_weight=0.5)),
    # three pods: the previous and next cluster differ
    "cluster_g3": ("mix_cluster", dict(n_clusters=3, inter_weight=0.3)),
    "median": ("mix_median", {}),
    "trimmed": ("mix_trimmed", dict(trim=2)),
    "geomedian": ("mix_geomedian", dict(n_iters=4)),
}
PSUM_MIXES = {
    "psum": ("mix_psum", {}),
    "psum_weighted": ("mix_psum",
                      dict(weights=np.arange(1.0, 9.0, dtype=np.float32))),
    "psum_dense": ("mix_psum_dense", dict(W=_w())),
    "psum_dense_kernel": ("mix_psum_dense", dict(W=_w(), use_kernel=True)),
    "divergence_psum": ("client_divergence_psum", {}),
}
LAYOUTS = {2: [("data", 2)], 3: [("cluster", 3)],
           4: [("data", 4), ("cluster", 2)]}
# the clients of each world's tree: 6 over 3 pods of 1 rank
CLIENTS = {2: MIX_C, 3: 6, 4: MIX_C}


def _dense(fn_name, tree, kw):
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    if fn_name == "client_divergence_psum":
        return aggregation.client_divergence(t).numpy()
    one_device = {"mix_neighbor_halo": "mix_rolls",
                  "mix_shift_halo": "mix_rolls", "mix_psum": "mix_all_reduce",
                  "mix_psum_dense": "mix_gather"}.get(fn_name, fn_name)
    fn = getattr(aggregation, one_device)
    out = fn(t, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _cases(d):
    c = CLIENTS[d]
    tree = _tree(c)
    cases = []
    for layout in LAYOUTS[d]:
        tag = f"{layout[0]}{d}"
        for name, (fn, kw) in {**GATHER_MIXES, **PSUM_MIXES}.items():
            if layout[0] == "cluster" and not name.startswith("cluster"):
                continue
            if c % kw.get("n_clusters", 1):
                continue
            cases.append((f"{name}@{tag}", layout, fn, tree, kw))
    return cases


@pytest.fixture(scope="module")
def mixes():
    """{(D, case name): (sharded result, one-device result)} from one
    gloo world of D ranks for each D."""
    out = {}
    for d in LAYOUTS:
        cases = _cases(d)
        got = mesh_lib.run_world(torch_dist.mixes_rank, d, backend="gloo",
                                 device="cpu", args=(cases,))
        for rank in got[1:]:   # every rank gathers the same result
            for name in rank:
                a, b = rank[name], got[0][name]
                if isinstance(a, dict):
                    assert all(np.array_equal(a[k], b[k]) for k in a), name
                else:
                    assert np.array_equal(a, b), name
        for name, _, fn, tree, kw in cases:
            out[name] = (got[0][name], _dense(fn, tree, kw))
    return out


def _names(table):
    return [name for d in LAYOUTS for name, *_ in _cases(d)
            if name.split("@")[0] in table]


@pytest.mark.parametrize("name", _names(GATHER_MIXES))
def test_gather_tier_mix_is_bitwise_the_one_device_mix(mixes, name):
    got, want = mixes[name]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", _names(PSUM_MIXES))
def test_psum_tier_mix_holds_to_tolerance(mixes, name):
    got, want = mixes[name]
    if isinstance(want, dict):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=PSUM_RTOL,
                                       atol=PSUM_RTOL, err_msg=f"{name} {k}")
    else:
        np.testing.assert_allclose(got, want, rtol=PSUM_RTOL)

