"""The port's cohort-sampled population, on the CPU: ``topology.
CohortSchedule`` and ``cohort_table``, ``rounds.PopulationStore``,
``rounds.run_blade_fl_cohort``, ``data.pipeline.CohortDataSource`` and the
trainer's ``--enrolled`` mode, against the JAX package where the two share
a contract (``tests/test_cohort.py`` is the model; its mesh and 4-device
cases wait for the port's multi-device slice).

The port draws a run's memberships up front from a generator of its own
(``cohort_table`` of the run seed), so they replay from the seed; the JAX
package draws them from its key stream, so the comparison with its driver
injects the reference's memberships through ``cohorts=``. Whole runs hold
to ``torch_runs``' rtol 1e-4 / atol 1e-5 (fp32 GEMMs in another order over
tau * K steps); the degenerate cohort (A = C_enrolled) is bitwise the
port's own loop.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import rounds as jrounds
from repro.core import topology as jtopology
from repro.launch import train as jtrain
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.core import rounds, topology
from repro_torch.data.pipeline import CohortDataSource
from repro_torch.launch import train
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.weights import params_from_jax
from torch_runs import ATOL, RTOL
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _tiny_params(seed=0):
    """The reference tests' 12-6 MLP, as numpy."""
    return {k: np.asarray(v) for k, v in
            jinit_mlp(jax.random.key(seed), in_dim=12, hidden=6).items()}


def _port_params(seed=0):
    return params_from_jax(_tiny_params(seed), "cpu")


def _batch_fn(seed=3, m=5):
    """(round_idx, cohort_idx) -> numpy [A, m, ...]: each client's data a
    function of its id alone."""
    def fn(round_idx, cohort_idx):
        rngs = [np.random.default_rng([seed, int(i)]) for i in cohort_idx]
        return {"x": np.stack([r.normal(size=(m, 12)).astype(np.float32)
                               for r in rngs]),
                "y": np.stack([r.integers(0, 10, m).astype(np.int32)
                               for r in rngs])}
    return fn


def _spec(a, **kw):
    kw.setdefault("topology", topology.FullMesh())
    return rounds.RoundSpec(n_clients=a, tau=2, eta=0.1, mine_attempts=16,
                            difficulty_bits=1, **kw)


# ---------------------------------------------------------------------------
# CohortSchedule: validation, weights, sampling statistics
# ---------------------------------------------------------------------------

BAD_SCHEDULES = [dict(n_enrolled=0, cohort_size=1),
                 dict(n_enrolled=4, cohort_size=5),
                 dict(n_enrolled=4, cohort_size=0),
                 dict(n_enrolled=4, cohort_size=2, bias="bogus"),
                 dict(n_enrolled=4, cohort_size=2, bias="pareto",
                      pareto_alpha=0.0)]


@pytest.mark.parametrize("kw", BAD_SCHEDULES)
def test_cohort_schedule_validation_matches_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jtopology.CohortSchedule(**kw)
    with pytest.raises(ValueError) as got:
        topology.CohortSchedule(**kw)
    assert str(got.value) == str(want.value)


def test_from_spec_parses_bias_strings():
    cs = topology.CohortSchedule.from_spec(100, 8, "pareto:2.5")
    assert cs.bias == "pareto" and cs.pareto_alpha == 2.5
    assert topology.CohortSchedule.from_spec(100, 8, "uniform").bias == \
        "uniform"
    assert topology.CohortSchedule.from_spec(100, 8, " Prefix").bias == \
        "prefix"
    with pytest.raises(ValueError):
        topology.CohortSchedule.from_spec(100, 8, "zipf")
    with pytest.raises(ValueError):
        topology.CohortSchedule.from_spec(100, 8, "pareto:nope")


@pytest.mark.parametrize("spec", ["uniform", "pareto", "pareto:1.5",
                                  "prefix"])
def test_weights_equal_the_reference(spec):
    want = jtopology.CohortSchedule.from_spec(37, 5, spec).weights()
    got = topology.CohortSchedule.from_spec(37, 5, spec).weights()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_weights_shapes_and_ordering():
    uni = topology.CohortSchedule(n_enrolled=10, cohort_size=3).weights()
    np.testing.assert_allclose(uni, np.full(10, 0.1), rtol=1e-12)
    par = topology.CohortSchedule(n_enrolled=10, cohort_size=3,
                                  bias="pareto", pareto_alpha=1.5).weights()
    assert par.shape == (10,) and abs(par.sum() - 1.0) < 1e-12
    assert np.all(np.diff(par) < 0)           # strictly head-heavy
    pre = topology.CohortSchedule(n_enrolled=10, cohort_size=3,
                                  bias="prefix").weights()
    assert pre[:3].sum() == pytest.approx(1.0) and np.all(pre[3:] == 0)


@pytest.mark.parametrize("bias", ["uniform", "pareto"])
def test_cohorts_are_sorted_distinct_in_range(bias):
    cs = topology.CohortSchedule(n_enrolled=50, cohort_size=7, bias=bias)
    table = topology.cohort_table(cs, 5, seed=0)
    assert table.shape == (5, 7) and table.dtype == np.int32
    assert np.all(np.diff(table, axis=1) > 0)       # sorted, distinct
    assert table.min() >= 0 and table.max() < 50


def test_prefix_cohort_is_arange():
    cs = topology.CohortSchedule(n_enrolled=50, cohort_size=7, bias="prefix")
    np.testing.assert_array_equal(topology.cohort_table(cs, 3, seed=4),
                                  np.tile(np.arange(7), (3, 1)))


def test_uniform_sampling_frequencies_chi_square():
    """Every enrolled client takes part at the uniform rate: the
    chi-square statistic of the per-client counts over a fixed seed's
    draws stays under the 99.9th percentile of chi2(C - 1)."""
    c, a, n_draws = 10, 3, 3000
    cs = topology.CohortSchedule(n_enrolled=c, cohort_size=a)
    counts = np.bincount(topology.cohort_table(cs, n_draws, 7).ravel(),
                         minlength=c)
    assert counts.sum() == n_draws * a
    expected = n_draws * a / c
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 27.9, f"chi2={chi2}, counts={counts}"   # chi2(9) @ .999


def test_pareto_sampling_is_head_heavy():
    c, a, n_draws = 20, 4, 1500
    cs = topology.CohortSchedule(n_enrolled=c, cohort_size=a,
                                 bias="pareto", pareto_alpha=1.5)
    counts = np.bincount(topology.cohort_table(cs, n_draws, 3).ravel(),
                         minlength=c)
    quartiles = counts.reshape(4, 5).sum(1)
    assert np.all(np.diff(quartiles) < 0), quartiles
    assert counts[0] > 3 * counts[-1]


def test_uniform_draws_differ_across_rounds():
    cs = topology.CohortSchedule(n_enrolled=200, cohort_size=5)
    draws = {tuple(row) for row in topology.cohort_table(cs, 6, 0)}
    assert len(draws) > 1


def test_cohort_stream_leaves_the_topology_stream_alone():
    """The memberships draw from a salted generator of their own, so a
    stochastic intra-cohort topology draws the same matrices as without a
    cohort."""
    seed = 5
    assert not torch.equal(topology.cohort_generator(seed).get_state(),
                           topology.topology_generator(seed).get_state())
    topo = topology.RandomGraph(p_link=0.5)
    want = topology.round_table(topo, 4, 3, topology.topology_generator(seed))
    topology.cohort_table(topology.CohortSchedule(40, 4), 3, seed)
    got = topology.round_table(topo, 4, 3, topology.topology_generator(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make", [topology.topology_generator,
                                  topology.cohort_generator])
def test_salted_streams_differ_by_run_seed(make):
    """The CPU generator keeps 32 bits of a seed: the run seed and the salt
    are hashed into them, so no two of these seeds share a stream."""
    draws = {tuple(torch.rand(4, generator=make(seed)).tolist())
             for seed in (0, 1, 2, 3, 2 ** 32)}
    assert len(draws) == 5


# ---------------------------------------------------------------------------
# PopulationStore
# ---------------------------------------------------------------------------


def test_population_store_is_lazy():
    params = _port_params()
    store = rounds.PopulationStore(params, 10_000, device="cpu")
    assert store.touched == 0 and store.materialized_bytes() == 0
    got = store.gather(np.array([3, 9_999]))
    for k, v in params.items():
        assert got[k].shape == (2,) + v.shape
        assert torch.equal(got[k][0], v) and torch.equal(got[k][1], v)
    assert store.touched == 0                  # gather alone touches nothing
    store.scatter(np.array([3, 9_999]), got)
    assert store.touched == 2
    row_bytes = sum(v.numel() * 4 for v in params.values())
    assert store.materialized_bytes() == 2 * row_bytes


def test_population_store_scatter_round_trips():
    params = _port_params(1)
    store = rounds.PopulationStore(params, 100, device="cpu")
    cohort = {k: torch.stack([v + 1.0, v + 2.0, v + 3.0])
              for k, v in params.items()}
    store.scatter(np.array([5, 50, 99]), cohort)
    back = store.gather(np.array([50, 99, 5]))
    for k, v in params.items():
        assert torch.equal(back[k], torch.stack([v + 2.0, v + 3.0, v + 1.0]))


def test_scattered_rows_survive_the_next_round():
    """A scatter copies each row out: the next gather refills the staging
    buffer and the next scatter overwrites the landing buffer, and the rows
    stored before stay as they were; a gather into ``out`` writes there."""
    params = _port_params(2)
    store = rounds.PopulationStore(params, 20, device="cpu")
    first = {k: torch.stack([v + 1.0, v - 1.0]) for k, v in params.items()}
    store.scatter(np.array([0, 1]), first)
    out = {k: torch.empty((2,) + v.shape) for k, v in params.items()}
    assert store.gather(np.array([2, 3]), out=out) is out
    store.scatter(np.array([2, 3]), {k: v * 7.0 for k, v in out.items()})
    back = store.gather(np.array([0, 1]))
    for k in params:
        assert torch.equal(back[k], first[k])
        assert torch.equal(out[k], torch.stack([params[k]] * 2))


def test_population_store_validates_indices():
    params = _port_params()
    with pytest.raises(ValueError):
        rounds.PopulationStore(params, 0, device="cpu")
    store = rounds.PopulationStore(params, 10, device="cpu")
    with pytest.raises(ValueError):
        store.gather(np.array([0, 10]))        # out of range
    with pytest.raises(ValueError):
        store.gather(np.array([-1]))
    with pytest.raises(ValueError):
        store.gather(np.zeros((2, 2), np.int64))
    cohort = {k: torch.stack([v, v]) for k, v in params.items()}
    with pytest.raises(ValueError):
        store.scatter(np.array([0, 1, 2]), cohort)   # leading-dim mismatch


# ---------------------------------------------------------------------------
# The cohort driver
# ---------------------------------------------------------------------------


def test_cohort_driver_validates_sizes():
    params = _port_params()
    cs = topology.CohortSchedule(n_enrolled=20, cohort_size=4)
    run = dict(device="cpu")
    with pytest.raises(ValueError, match="cohort_size"):
        rounds.run_blade_fl_cohort(mlp_client_losses, _spec(5), params,
                                   _batch_fn(), 2, cs, **run)
    wrong_store = rounds.PopulationStore(params, 30, device="cpu")
    with pytest.raises(ValueError, match="n_enrolled"):
        rounds.run_blade_fl_cohort(mlp_client_losses, _spec(4), params,
                                   _batch_fn(), 2, cs, store=wrong_store,
                                   **run)
    static = _batch_fn()(0, np.arange(19))
    with pytest.raises(ValueError, match="static batches leading dims"):
        rounds.run_blade_fl_cohort(mlp_client_losses, _spec(4), params,
                                   static, 2, cs, **run)
    with pytest.raises(ValueError, match="cohorts of shape"):
        rounds.run_blade_fl_cohort(mlp_client_losses, _spec(4), params,
                                   _batch_fn(), 2, cs,
                                   cohorts=np.zeros((3, 4), np.int32), **run)
    with pytest.raises(ValueError, match="cohort indices"):
        rounds.run_blade_fl_cohort(mlp_client_losses, _spec(4), params,
                                   _batch_fn(), 1, cs,
                                   cohorts=[[0, 1, 2, 20]], **run)


def test_cohort_replay_from_the_seed():
    """The recorded cohorts are ``cohort_table`` of the run seed, and of
    nothing else: another seed draws other memberships."""
    params = _port_params()
    cs = topology.CohortSchedule(n_enrolled=60, cohort_size=4)
    _, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, _spec(4), params, _batch_fn(), 4, cs, seed=2,
        device="cpu")
    assert ledger.validate_chain() and len(ledger.blocks) == 4
    recorded = [h["cohort"] for h in hist]
    assert topology.cohort_table(cs, 4, 2).tolist() == recorded
    assert topology.cohort_table(cs, 4, 3).tolist() != recorded
    assert rounds.LAST_DISPATCH["driver"] == "cohort"
    assert rounds.LAST_DISPATCH["reason"] == "cohort A=4 over C_enrolled=60"


@pytest.mark.parametrize("batch_kind", ["static", "callable"])
def test_degenerate_cohort_equals_the_loop_bitwise(batch_kind):
    """A = C_enrolled under ``prefix``: every client takes part every
    round, so the cohort driver is the port's loop driver, bit for bit:
    params, every history metric and the ledger."""
    c, k, seed = 6, 4, 3
    params = _port_params(1)
    batch = _batch_fn(seed=9, m=8)(0, np.arange(c))
    spec = _spec(c, n_lazy=1, sigma2=0.01)
    state, hist_d, led_d = rounds.run_blade_fl(
        mlp_client_losses, spec, params,
        {n: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                             else v) for n, v in batch.items()},
        k, seed=seed, device="cpu")
    cs = topology.CohortSchedule(n_enrolled=c, cohort_size=c, bias="prefix")
    batches = batch if batch_kind == "static" else (lambda r, idx: batch)
    store, hist_c, led_c = rounds.run_blade_fl_cohort(
        mlp_client_losses, spec, params, batches, k, cs, seed=seed,
        device="cpu")
    final = store.gather(np.arange(c))
    for name, v in state.params.items():
        assert torch.equal(final[name], v), name
    assert led_c.blocks == led_d.blocks and led_c.validate_chain()
    for hc, hd in zip(hist_c, hist_d):
        assert hc.pop("cohort") == list(range(c))
        assert list(hc) == list(hd)
        np.testing.assert_array_equal(np.array(list(hc.values())),
                                      np.array(list(hd.values())))


def test_cohort_run_touches_only_participants():
    params = _port_params()
    cs = topology.CohortSchedule(n_enrolled=10_000, cohort_size=4)
    store, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, _spec(4), params, _batch_fn(), 3, cs,
        device="cpu")
    active = {i for h in hist for i in h["cohort"]}
    assert store.touched == len(active) <= 12
    assert ledger.validate_chain() and len(ledger.blocks) == 3
    assert ledger.blocks[0].prev_hash == rounds.chain.GENESIS_HASH
    some = store.gather(np.array(sorted(active)[:2]))
    assert any(not torch.equal(some[k][0], v) for k, v in params.items())


def test_cohort_driver_matches_the_reference():
    """The port's driver against the JAX package's on the same params and
    static numpy batches, the reference's memberships injected: every
    round's cohort equal, losses and divergence, and every touched
    client's row within rtol 1e-4 / atol 1e-5."""
    enrolled, a, k = 12, 4, 3
    np_params = _tiny_params(0)
    batch = _batch_fn(seed=11, m=6)(0, np.arange(enrolled))
    fields = dict(n_clients=a, tau=2, eta=0.1, n_lazy=1, sigma2=0.0,
                  mine_attempts=16, difficulty_bits=1)
    jstore, jhist, jledger = jrounds.run_blade_fl_cohort(
        jmlp_loss, jrounds.RoundSpec(**fields),
        {n: jnp.asarray(v) for n, v in np_params.items()}, batch,
        jax.random.key(1), k,
        jtopology.CohortSchedule(n_enrolled=enrolled, cohort_size=a))
    cohorts = np.array([h["cohort"] for h in jhist])
    store, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, rounds.RoundSpec(**fields),
        params_from_jax(np_params, "cpu"), batch, k,
        topology.CohortSchedule(n_enrolled=enrolled, cohort_size=a),
        cohorts=cohorts, device="cpu")
    assert [h["cohort"] for h in hist] == [h["cohort"] for h in jhist]
    for r, (h, jh) in enumerate(zip(hist, jhist)):
        for name in ("local_loss_mean", "global_loss", "divergence"):
            np.testing.assert_allclose(h[name], jh[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"round {r} {name}")
    touched = np.array(sorted({i for h in jhist for i in h["cohort"]}))
    assert store.touched == jstore.touched == len(touched)
    got, want = store.gather(touched), jstore.gather(touched)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert ledger.validate_chain() and jledger.validate_chain()
    assert len(ledger.blocks) == len(jledger.blocks) == k


# ---------------------------------------------------------------------------
# CohortDataSource and the trainer
# ---------------------------------------------------------------------------


def test_cohort_data_source_is_deterministic_per_client():
    a = CohortDataSource(7, samples_per_client=32, device="cpu")
    b = CohortDataSource(7, samples_per_client=32, device="cpu")
    batch = a.cohort_batch(0, [3, 40, 999])
    assert batch["x"].shape == (3, 32, 784) and batch["x"].dtype == \
        torch.float32
    assert batch["y"].shape == (3, 32) and batch["y"].dtype == torch.int64
    assert bool(((batch["x"] > 0) & (batch["x"] < 1)).all())
    for i, cid in enumerate([3, 40, 999]):
        other = b.client_batch(cid)
        assert torch.equal(batch["x"][i], other["x"])
        assert torch.equal(batch["y"][i], other["y"])
    assert not torch.equal(a.client_batch(3)["x"], a.client_batch(4)["x"])
    other_seed = CohortDataSource(8, samples_per_client=32, device="cpu")
    assert not torch.equal(a.client_batch(3)["x"],
                           other_seed.client_batch(3)["x"])
    assert a.eval_data["x"].shape == (2048, 784)


def test_cohort_data_source_cache_is_lru_bounded():
    src = CohortDataSource(0, samples_per_client=4, cache_size=3,
                           device="cpu")
    first = src.client_batch(0)
    for cid in (1, 2):
        src.client_batch(cid)
    assert src.client_batch(0) is first          # a hit refreshes client 0
    src.client_batch(3)                           # evicts client 1
    assert len(src._cache) == 3 and list(src._cache) == [2, 0, 3]
    assert src.client_batch(0) is first
    rebuilt = src.client_batch(1)
    assert len(src._cache) == 3 and 2 not in src._cache
    assert torch.equal(rebuilt["x"], CohortDataSource(
        0, samples_per_client=4, device="cpu").client_batch(1)["x"])
    with pytest.raises(ValueError):
        CohortDataSource(0, samples_per_client=4, cache_size=0, device="cpu")


def test_cohort_data_source_is_label_skewed():
    """Each client's labels follow its own Dirichlet(alpha) proportions:
    at alpha 0.1 a client's most common class holds far more than the
    tenth it holds in the unskewed eval set."""
    src = CohortDataSource(1, samples_per_client=200, dirichlet_alpha=0.1,
                           device="cpu")
    batch = src.cohort_batch(0, range(8))
    top = [np.bincount(y.numpy(), minlength=10).max() / 200
           for y in batch["y"]]
    assert np.mean(top) > 0.5
    eval_top = np.bincount(src.eval_data["y"].numpy(), minlength=10).max()
    assert eval_top / 2048 < 0.15


def test_trainer_cohort_mode_returns_the_reference_keys(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    flags = ["--arch", "mlp", "--enrolled", "50", "--cohort", "4", "--k",
             "2", "--t-sum", "24"]
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--out-dir",
                                      str(tmp_path / "ref")])
    jtrain.main()
    want = json.loads(capsys.readouterr().out)
    train.main(flags + ["--device", "cpu", "--out-dir",
                        str(tmp_path / "port")])
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["chain_valid"] is True and got["blocks"] == 2
    assert got["enrolled"] == 50 and got["cohort"] == 4 and got["tau"] == 2
    assert 4 <= got["touched"] <= 8 and got["devices"] == 1
    assert got["dispatch"]["driver"] == "cohort"

    def records(sub):
        lines = (tmp_path / sub / "blade_cohort.jsonl").read_text()
        return [json.loads(line) for line in lines.splitlines()]

    ref, port = records("ref"), records("port")
    assert len(port) == len(ref) == 2
    assert [set(r) for r in port] == [set(r) for r in ref]
