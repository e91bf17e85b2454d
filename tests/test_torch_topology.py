"""The port's topologies, resolver and spectral diagnostics against the JAX
package, and its whole runs over the topology path.

Deterministic mixing matrices are built the same way in float32 in both
packages, so they must be equal bit for bit, at every schedule phase.
``resolve_mix_plan`` must pick the same executor on the whole flag grid
(rejections included). Whole runs hold to rtol 1e-4 / atol 1e-5
(``torch_runs.py``); a stochastic topology's draws are injected from the
reference's own topology stream.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import rounds as jrounds
from repro.core import spectral as jspectral
from repro.core import topology as jtopology
from repro_torch.core import rounds, spectral, topology
from repro_torch.launch import train
from torch_runs import assert_runs_close, run_pair, specs
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

# every from_name spelling family, with and without arguments
NAMES = ["full", "mesh", "ring", "ring:2", "partial:2", "shift", "shift:3",
         "cluster:2", "cluster:2:0.5", "rotate", "rotate:3", "alt",
         "alt:2:1", "snr", "snr:4"]


def _both(name):
    return jtopology.from_name(name), topology.from_name(name)


def _phases(topo, c):
    return topo.period(c) if isinstance(topo, topology.Schedule) else 1


@pytest.mark.parametrize("c", [4, 8, 20])
@pytest.mark.parametrize("name", NAMES)
def test_matrices_bitwise_at_every_phase(name, c):
    jt, t = _both(name)
    assert repr(t) == repr(jt)
    for phase in range(_phases(t, c)):
        want = np.asarray(jt.matrix(c, round_idx=phase))
        got = t.matrix(c, round_idx=phase)
        assert got.dtype == np.float32 and got.shape == (c, c)
        np.testing.assert_array_equal(got, want, err_msg=f"phase {phase}")
    table = topology.round_table(t, c, 2 * _phases(t, c))
    for k in range(2 * _phases(t, c)):
        np.testing.assert_array_equal(
            table[k % len(table)], np.asarray(jt.matrix(c, round_idx=k)))


@pytest.mark.parametrize("name", NAMES + ["random:0.5"])
def test_lowering_uniform_row_and_sparse_export_match(name):
    jt, t = _both(name)
    # both tiers' lowerings (the psum kind under fast_allreduce) and the
    # uniform row the psum kind rests on
    for c in (4, 8, 16):
        for fast in (False, True):
            jl = jt.lowering(c, fast_allreduce=fast)
            lo = t.lowering(c, fast_allreduce=fast)
            assert (lo.kind, lo.offsets, lo.weight, lo.offsets_table) == \
                (jl.kind, jl.offsets, jl.weight, jl.offsets_table)
        jrow, row = jt.uniform_row(c), t.uniform_row(c)
        assert (row is None) == (jrow is None)
        if row is not None:
            np.testing.assert_array_equal(row, np.asarray(jrow))
        assert t.is_full_mesh == jt.is_full_mesh
        jsp, sp = jt.sparse_lowering(c), t.sparse_lowering(c)
        assert (sp is None) == (jsp is None)
        if sp is not None:
            np.testing.assert_array_equal(sp.neighbor_idx, jsp.neighbor_idx)
            np.testing.assert_array_equal(sp.edge_w, jsp.edge_w)


def test_explicit_sparse_and_ring_neighbors_match():
    nbrs = topology.ring_neighbors(7, 2)
    assert nbrs == jtopology.ring_neighbors(7, 2)
    weights = tuple(tuple(float(i + j + 1) for j in range(len(r)))
                    for i, r in enumerate(nbrs))
    t = topology.ExplicitSparse(neighbors=nbrs, weights=weights)
    jt = jtopology.ExplicitSparse(neighbors=nbrs, weights=weights)
    np.testing.assert_array_equal(t.matrix(7), np.asarray(jt.matrix(7)))
    back = topology.ExplicitSparse.from_lowering(t.sparse_lowering(7))
    jback = jtopology.ExplicitSparse.from_lowering(jt.sparse_lowering(7))
    assert back == topology.ExplicitSparse(jback.neighbors, jback.weights)
    w = np.asarray(jt.matrix(7))
    sp, jsp = topology.sparse_from_dense(w), jtopology.sparse_from_dense(w)
    np.testing.assert_array_equal(sp.neighbor_idx, jsp.neighbor_idx)
    np.testing.assert_array_equal(sp.reweighted(np.arange(1.0, 8.0)).edge_w,
                                  jsp.reweighted(np.arange(1.0, 8.0)).edge_w)


def test_random_graph_draws_are_row_stochastic_and_seeded():
    t = topology.from_name("random:0.5")
    assert t.stochastic and repr(t) == repr(jtopology.from_name("random:0.5"))
    a = topology.round_table(t, 6, 4, topology.topology_generator(3))
    b = topology.round_table(t, 6, 4, topology.topology_generator(3))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 6, 6) and a.dtype == np.float32
    np.testing.assert_allclose(a.sum(axis=2), 1.0, rtol=1e-6)
    assert (np.diagonal(a, axis1=1, axis2=2) > 0).all()
    assert not np.array_equal(a[0], a[1])
    with pytest.raises(ValueError):
        t.matrix(6)
    # the topology stream is not the lazy / DP generator of the same seed
    plain = torch.rand((6, 6), generator=torch.Generator().manual_seed(3))
    assert not np.array_equal((plain.numpy() < 0.5), a[0] > 0)


def _flag_grid():
    return itertools.product([False, True], [None, True, False],
                             [None, tuple(float(i + 1) for i in range(16))],
                             [None, "mean", "median", "trimmed:2",
                              "geomed:3"])


def _plan_fields(plan):
    return (plan.mode, plan.kind, plan.mix, plan.offsets, plan.weight,
            plan.offsets_table, plan.period, plan.use_kernel,
            plan.needs_matrix, plan.n_clusters, plan.inter_weight,
            plan.trim, plan.robust_iters)


@pytest.mark.parametrize("name", ["full", "ring", "ring:8", "random:0.5",
                                  "partial:2", "partial:8", "shift:5",
                                  "cluster:4", "rotate", "alt", "snr",
                                  "explicit"])
def test_resolver_matches_reference_on_the_flag_grid(name):
    c = 16
    if name == "explicit":
        nbrs = topology.ring_neighbors(c, 1)
        jt = jtopology.ExplicitSparse(neighbors=nbrs)
        t = topology.ExplicitSparse(neighbors=nbrs)
    else:
        jt, t = _both(name)
    for fused, sparse, dw, robust in _flag_grid():
        common = dict(n_clients=c, tau=1, eta=0.1, fused_mix=fused,
                      sparse_mix=sparse, data_weights=dw, robust_agg=robust)
        jspec = jrounds.RoundSpec(topology=jt, **common)
        spec = rounds.RoundSpec(topology=t, **common)
        try:
            want = jtopology.resolve_mix_plan(jspec)
        except ValueError as e:
            with pytest.raises(ValueError) as got_err:
                topology.resolve_mix_plan(spec)
            assert str(got_err.value) == str(e)
            continue
        plan = topology.resolve_mix_plan(spec)
        assert _plan_fields(plan) == _plan_fields(want), common
        assert (plan.weights is None) == (want.weights is None)
        if plan.weights is not None:
            np.testing.assert_array_equal(plan.weights, want.weights)
        assert (plan.sparse is None) == (want.sparse is None)
        if plan.sparse is not None:
            np.testing.assert_array_equal(plan.sparse.edge_w,
                                          want.sparse.edge_w)
        assert rounds.dispatch_plan(spec, "cpu")["mix_mode"] == plan.mode


@pytest.mark.parametrize("name", ["full", "ring", "ring:2", "partial:3",
                                  "cluster:3:0.5", "rotate", "alt:2:1",
                                  "snr:4"])
def test_gap_report_matches_reference(name):
    jt, t = _both(name)
    c, k = 6, 7
    want = jspectral.gap_report(jt, c, k)
    got = spectral.gap_report(t, c, k)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["gap_per_round"], want["gap_per_round"],
                               rtol=1e-9, atol=1e-12)
    for key in ("gap_min", "gap_mean", "ergodic_gap",
                "predicted_consensus_rate"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    assert spectral.ergodic_gap(t, c) == pytest.approx(
        jspectral.ergodic_gap(jt, c), abs=1e-12)


def test_stochastic_gap_report_from_drawn_matrices_and_seed():
    jt, t = _both("random:0.5")
    c, k = 6, 4
    key = jax.random.key(5)
    keys = jrounds.topology_keys(key, k)
    mats = np.stack([np.asarray(jt.matrix(c, key=kk, round_idx=i))
                     for i, kk in enumerate(keys)])
    want = jspectral.gap_report(jt, c, k, keys=keys)
    got = spectral.gap_report(t, c, k, matrices=mats)
    np.testing.assert_allclose(got["gap_per_round"], want["gap_per_round"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["ergodic_gap"], want["ergodic_gap"],
                               rtol=1e-9, atol=1e-12)
    # a run's seed draws its table from the salted topology stream; the
    # report reads the table it is handed
    table = topology.round_table(t, c, k, topology.topology_generator(9))
    drawn = rounds.mix_matrices(rounds.RoundSpec(n_clients=c, tau=1, eta=0.1,
                                                 topology=t),
                                k, seed=9, device="cpu").numpy()
    np.testing.assert_array_equal(table, drawn)
    np.testing.assert_array_equal(
        np.stack(spectral.round_matrices(t, c, k, matrices=table)), table)
    with pytest.raises(ValueError):
        spectral.gap_report(t, c, k)
    for g, a, s in [(8, 0.3, 1), (4, 0.5, 3), (1, 0.5, 4)]:
        assert spectral.cluster_spectral_gap(g, a, cluster_size=s) == \
            jspectral.cluster_spectral_gap(g, a, cluster_size=s)


@pytest.mark.parametrize("name,c,fused,inject", [
    ("random:0.5", 4, True, True),
    ("ring:1", 4, False, False),
    ("rotate", 4, False, False),
    ("cluster:2", 4, False, False),
    ("partial:2", 16, False, False),
    ("snr:2", 4, True, False),
])
def test_whole_run_matches_reference_loop(name, c, fused, inject):
    jt, t = _both(name)
    jspec, spec = specs(c, jax_fields=dict(topology=jt,
                                           kernel_interpret=True),
                        torch_fields=dict(topology=t), fused_mix=fused)
    want_mode = jtopology.resolve_mix_plan(jspec).mode
    assert topology.resolve_mix_plan(spec).mode == want_mode
    ref, got = run_pair(jspec, spec, inject_matrices=inject)
    assert rounds.LAST_DISPATCH["mix_mode"] == want_mode
    assert_runs_close(ref, got)


@pytest.mark.parametrize("flags,mode,mix", [
    (["--topology", "random:0.5", "--fused-mix"], "exec_gather", "fused"),
    (["--topology", "ring", "--schedule", "rotate"], "exec_shift_table",
     "jnp"),
    (["--topology", "snr:2", "--attack", "alie", "--attackers", "1",
      "--robust", "trimmed:1"], "exec_trimmed", "robust"),
])
def test_trainer_runs_the_topology_and_adversarial_paths_on_cpu(flags, mode,
                                                                 mix):
    args = train.build_parser().parse_args(
        ["--k", "2", "--clients", "4", "--t-sum", "24", "--device", "cpu"]
        + flags)
    result, state, hist = train.train_mlp(args)
    assert result["dispatch"]["mix_mode"] == mode
    assert result["dispatch"]["mix"] == mix
    assert result["chain_valid"] and result["blocks"] == 2
    assert all(np.isfinite(h["global_loss"]) for h in hist)
    assert 0.0 <= result["spectral_gap_min"] <= result["spectral_gap_mean"]
    # the run's topology draws come from its salted stream, so a second
    # run of the same seed mixes, and reports, the same matrices
    again, _, _ = train.train_mlp(args)
    assert again["ergodic_gap"] == result["ergodic_gap"]
    assert again["final_global_loss"] == result["final_global_loss"]
