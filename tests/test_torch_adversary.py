"""The port's adversarial communicate stage against the JAX package, on the
CPU: the four attacks, the robust reducers, lazy detection and whole runs
with an attack and a robust aggregator.

Randomness is injected: ScaledNoise gets the reference's per-leaf draws,
detection the reference's sketch projection. Attacks and reducers hold to
rtol 1e-5 / atol 1e-6 (fp32 sums in another order); whole runs to rtol
1e-4 / atol 1e-5 (``torch_runs.py``), against the reference's per-round
loop and never its scan-vs-loop bitwise claims.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.core import attacks as jattacks
from repro.core import detection as jdetection
from repro.core import topology as jtopology
from repro_torch.core import aggregation, attacks, detection, rounds, \
    topology
from torch_runs import assert_runs_close, run_pair, specs
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 1e-5, 1e-6
ATTACK_SPECS = ["signflip", "signflip:2.5", "noise", "noise:0.5:2",
                "alie", "alie:0.7", "replace", "replace:3"]


def _tree(c, seed, hidden=16):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (784, hidden), "b1": (hidden,), "w2": (hidden, 10),
              "b2": (10,)}
    return {k: rng.normal(size=(c,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ATTACK_SPECS)
@pytest.mark.parametrize("m", [1, 2])
def test_attack_matches_reference(name, m):
    c = 5
    jatk, atk = jattacks.from_name(name, m), attacks.from_name(name, m)
    assert repr(atk) == repr(jatk)
    full = _tree(c, m)
    key = jax.random.key(3)
    want = jax.jit(lambda f, k: jatk.apply(f, k, c))(_jt(full), key)
    # the reference's per-leaf draws (one key per leaf, sorted order)
    keys = jax.random.split(key, len(full))
    noise = {k: torch.from_numpy(np.array(jax.random.normal(
        kk, full[k].shape, jnp.float32))) for k, kk in zip(sorted(full), keys)}
    got = atk.apply(_tt(full), c, torch.Generator(), noise)
    _close(got, want)
    for k in full:   # honest rows pass through untouched
        np.testing.assert_array_equal(got[k][m:].numpy(), full[k][m:])


def test_attack_stage_identity_validation_and_generator_draws():
    c = 4
    full = _tt(_tree(c, 0))
    spec = rounds.RoundSpec(n_clients=c, tau=1, eta=0.1)
    assert rounds.make_attack(spec)(full, torch.Generator()) is full
    spec = rounds.RoundSpec(n_clients=c, tau=1, eta=0.1,
                            attack=attacks.SignFlip(n_attackers=0))
    assert rounds.make_attack(spec)(full, torch.Generator()) is full
    with pytest.raises(ValueError, match="honest"):
        rounds.make_attack(rounds.RoundSpec(
            n_clients=c, tau=1, eta=0.1,
            attack=attacks.ALIE(n_attackers=c)))
    spec = rounds.RoundSpec(n_clients=c, tau=1, eta=0.1,
                            attack=attacks.ScaledNoise(n_attackers=1))
    stage = rounds.make_attack(spec)
    a = stage(full, torch.Generator().manual_seed(4))
    b = stage(full, torch.Generator().manual_seed(4))
    for k in full:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k][:1], full[k][:1])
        assert torch.equal(a[k][1:], full[k][1:])
    with pytest.raises(ValueError):
        attacks.from_name("bogus")


@pytest.mark.parametrize("c", [4, 5])
def test_robust_median_matches_jnp_median(c):
    tree = _tree(c, 10 + c)
    tree["b1"][:, 0] = 1.0   # ties
    got = aggregation.robust_median(_tt(tree))
    _close(got, jagg.robust_median(_jt(tree)))
    _close(got, jagg.mix_median(_jt(tree)))


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_robust_trimmed_matches_reference(trim):
    tree = _tree(6, 20 + trim)
    got = aggregation.robust_trimmed(_tt(tree), trim)
    _close(got, jagg.robust_trimmed(_jt(tree), trim))
    _close(got, jagg.mix_trimmed(_jt(tree), trim))
    with pytest.raises(ValueError):
        aggregation.robust_trimmed(_tt(tree), 3)


@pytest.mark.parametrize("iters", [1, 3, 8])
def test_robust_geomedian_matches_reference(iters):
    tree = _tree(5, 30 + iters)
    tree["w2"][0] += 50.0    # one far-away client
    got = aggregation.robust_geomedian(_tt(tree), iters)
    _close(got, jagg.robust_geomedian(_jt(tree), iters), rtol=1e-5,
           atol=1e-5)
    _close(got, jagg.mix_geomedian(_jt(tree), iters), rtol=1e-5, atol=1e-5)


def test_parse_robust_matches_reference():
    for name in ("median", "trimmed", "trimmed:2", "trim:1", "geomed",
                 "geomed:3", "geometric_median"):
        assert topology.parse_robust(name, 8) == \
            jtopology.parse_robust(name, 8)
    for bad in ("trimmed:4", "geomed:0", "mode"):
        with pytest.raises(ValueError):
            jtopology.parse_robust(bad, 8)
        with pytest.raises(ValueError):
            topology.parse_robust(bad, 8)


def _reference_projection(full, seed=0, sketch_dim=256):
    f = sum(v[0].size for v in full.values())
    proj = jax.random.normal(jax.random.key(seed), (f, sketch_dim)) \
        * (f ** -0.5)
    return torch.from_numpy(np.array(proj))


@pytest.mark.parametrize("sigma", [0.0, 1e-3, 3.0])
def test_detection_matches_reference_with_its_projection(sigma):
    c = 6
    prev = _tree(c, 40)
    full = {k: v + 0.05 * np.random.default_rng(41).normal(size=v.shape)
            .astype(np.float32) for k, v in prev.items()}
    for k in full:   # client 0 plagiarizes client 3 with disguise noise
        full[k][0] = full[k][3] + sigma * np.random.default_rng(42).normal(
            size=full[k][3].shape).astype(np.float32)
    proj = _reference_projection(full)
    jmask, jfrac = jax.jit(jdetection.detect_lazy)(_jt(full))
    mask, frac = detection.detect_lazy(_tt(full), proj)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # |a|^2 + |b|^2 - 2 a.b cancels for a near-copy: its distance carries an
    # absolute error of about sqrt(eps32) * |a| in either package, about
    # 1e-3 of the median distance here
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), rtol=1e-4,
                               atol=2e-3)
    jmask, jnorms = jax.jit(jdetection.detect_lazy_round)(_jt(full),
                                                          _jt(prev))
    mask, norms = detection.detect_lazy_round(_tt(full), _tt(prev), proj)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=1e-4)
    assert detection.detection_metrics(mask, 1) == \
        jdetection.detection_metrics(jmask, 1)
    assert detection.detection_metrics(mask & False, 0) == \
        jdetection.detection_metrics(jmask & False, 0)


@pytest.mark.parametrize("c,attack,m,robust", [
    (4, "signflip", 1, "median"),
    (5, "alie", 2, "trimmed:1"),
    (4, "replace", 1, "geomed:3"),
    (4, "signflip", 1, None),
])
def test_whole_run_with_attack_and_robust_matches_reference(c, attack, m,
                                                            robust):
    jspec, spec = specs(c, jax_fields=dict(attack=jattacks.from_name(
                            attack, m)),
                        torch_fields=dict(attack=attacks.from_name(
                            attack, m)), robust_agg=robust)
    ref, got = run_pair(jspec, spec)
    assert rounds.LAST_DISPATCH["mix_mode"] == \
        jtopology.resolve_mix_plan(jspec).mode
    assert_runs_close(ref, got)


def test_whole_run_with_lazy_detection_counts_the_same_suspects():
    jspec, spec = specs(4, detect_lazy=True, robust_agg="median")
    ref, got = run_pair(jspec, spec)
    assert_runs_close(ref, got)
    jhist, hist = ref[1], got[1]
    # a lazy copy without noise and its source: flagged in every round
    assert [h["n_suspects"] for h in hist] == \
        [h["n_suspects"] for h in jhist]
    assert all(h["n_suspects"] >= 2 for h in hist)
