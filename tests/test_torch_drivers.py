"""The port's two round drivers and their shared step, on the CPU.

A run's noise is drawn before its first round (``rounds.draw_noise``) in
the order the stages draw it round by round, so the round step over static
buffers (``rounds.RoundRunner``, which the loop driver calls and the graph
driver captures) gives the same bits as the stages drawing for themselves
in the loop the port ran before (``torch_runs.stage_loop``). Stacked and
callable batches hold to the JAX package's runs at rtol 1e-4 / atol 1e-5
(``torch_runs``). ``dispatch_plan`` reads only the device's type, so its
graph decision is checked without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_runs
from repro.core import rounds as jrounds
from repro.core import topology as jtopology
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.core import attacks, rounds, topology
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.weights import batch_from_numpy, params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

C, K = 4, 3


def _cpu_inputs(seed=0):
    params, batch = torch_runs.inputs(C, seed)
    return params_from_jax(params, "cpu"), batch_from_numpy(batch, "cpu")


def test_noise_drawn_up_front_equals_the_stages_draws():
    """Lazy, DP and ScaledNoise all drawing: the stages fed round k of the
    table give the bits the stages drawing from the generator give, and
    the generator ends in the same state."""
    spec = rounds.RoundSpec(
        n_clients=C, tau=1, eta=0.1, n_lazy=1, sigma2=0.01, dp_sigma=0.05,
        attack=attacks.ScaledNoise(n_attackers=2, sigma2=0.1, scale=1.5))
    params, _ = _cpu_inputs()
    full = rounds.init_state(params, C, None).params
    perturb, attack = rounds.make_perturb(spec), rounds.make_attack(spec)
    drawing = torch.Generator().manual_seed(7)
    ahead = torch.Generator().manual_seed(7)
    table = rounds.draw_noise(spec, full, K, ahead, "cpu")
    assert set(table) == {"lazy", "dp", "attack"}
    assert table["lazy"]["w1"].shape == (K, 1) + full["w1"].shape[1:]
    assert table["dp"]["w1"].shape == (K,) + full["w1"].shape
    unused = torch.Generator().manual_seed(99)
    for k in range(K):
        want = attack(perturb(full, drawing), drawing)
        noise = {stage: {n: v[k] for n, v in leaves.items()}
                 for stage, leaves in table.items()}
        got = attack(perturb(full, unused, noise["lazy"], noise["dp"]),
                     unused, noise["attack"])
        for name in full:
            assert torch.equal(got[name], want[name]), (k, name)
    assert torch.equal(drawing.get_state(), ahead.get_state())
    assert torch.equal(unused.get_state(),
                       torch.Generator().manual_seed(99).get_state())


def test_noise_table_is_empty_when_no_stage_draws():
    spec = rounds.RoundSpec(n_clients=C, tau=1, eta=0.1, n_lazy=1,
                            sigma2=0.0, attack=attacks.SignFlip(1))
    params, _ = _cpu_inputs()
    gen = torch.Generator().manual_seed(3)
    assert rounds.draw_noise(spec, params, K, gen, "cpu") == {}
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(3).get_state())


# the RoundSpec fields of each path the step-form loop is held to the
# stage loop on: noise in every stage, a stochastic topology on the dense
# kernel mix, a shift schedule (one graph a phase on the card), an eval
# stride, and two attacks with a robust or a ring mix
STEP_PATHS = {
    "paper": dict(n_lazy=1, sigma2=0.01, dp_sigma=0.001),
    "random_fused": dict(n_lazy=1, sigma2=0.01,
                         topology=topology.from_name("random:0.5"),
                         fused_mix=True),
    "shift_schedule": dict(topology=topology.from_name("rotate")),
    "eval_every_2": dict(n_lazy=1, sigma2=0.01, eval_every=2),
    "attack_noise_median": dict(
        attack=attacks.from_name("noise:0.1:1.5", 1), robust_agg="median",
        detect_lazy=True),
    "attack_alie_ring": dict(attack=attacks.from_name("alie", 1),
                             topology=topology.from_name("ring")),
}


@pytest.mark.parametrize("path", sorted(STEP_PATHS))
@pytest.mark.parametrize("k", [1, K])
def test_step_loop_equals_the_stage_loop_bitwise(path, k):
    spec = rounds.RoundSpec(**{**torch_runs.BASE, "n_clients": C,
                               **STEP_PATHS[path]})
    params, batch = _cpu_inputs()
    want = torch_runs.stage_loop(mlp_client_losses, spec, params, batch, k,
                                 seed=5)
    got = rounds.run_blade_fl(mlp_client_losses, spec, params, batch, k,
                              seed=5, device="cpu")
    assert rounds.LAST_DISPATCH["driver"] == "loop"
    torch_runs.assert_runs_bitwise(want, got)
    if path == "eval_every_2" and k == K:
        assert [np.isnan(h["global_loss"]) for h in got[1]] == \
            [True, False, False]   # the last round evaluates


def test_step_leaves_the_caller_params_untouched():
    spec = rounds.RoundSpec(**{**torch_runs.BASE, "n_clients": C})
    params, batch = _cpu_inputs()
    before = {k: v.clone() for k, v in params.items()}
    rounds.run_blade_fl(mlp_client_losses, spec, params, batch, 2,
                        device="cpu")
    assert all(torch.equal(params[k], before[k]) for k in params)


def _stacked_batch(seed=0):
    rng = np.random.default_rng(seed + 11)
    return {"x": rng.uniform(0, 1, (K, C, torch_runs.M, 784))
            .astype(np.float32),
            "y": rng.integers(0, 10, (K, C, torch_runs.M)).astype(np.int32)}


@pytest.mark.parametrize("mode", ["stacked", "callable"])
def test_stacked_and_callable_batches_match_the_reference(mode):
    jspec, spec = torch_runs.specs(C)
    params, _ = torch_runs.inputs(C)
    stacked = _stacked_batch()
    key = jax.random.key(1)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstacked = {n: jnp.asarray(v) for n, v in stacked.items()}
    tstacked = batch_from_numpy(stacked, "cpu")
    if mode == "stacked":
        ref = jrounds.run_blade_fl(jmlp_loss, jspec, jparams, jstacked, key,
                                   K, stacked=True)
        got = rounds.run_blade_fl(mlp_client_losses, spec,
                                  params_from_jax(params, "cpu"), tstacked,
                                  K, device="cpu", stacked=True)
        reason = "CPU run: CUDA graphs need the card"
    else:
        ref = jrounds.run_blade_fl(
            jmlp_loss, jspec, jparams,
            lambda k: {n: v[k] for n, v in jstacked.items()}, key, K)
        got = rounds.run_blade_fl(
            mlp_client_losses, spec, params_from_jax(params, "cpu"),
            lambda k: {n: v[k] for n, v in tstacked.items()}, K,
            device="cpu")
        reason = "per-round batch callable"
    assert rounds.LAST_DISPATCH["driver"] == "loop"
    assert rounds.LAST_DISPATCH["reason"] == reason
    torch_runs.assert_runs_close(ref, got)


def test_stacked_batch_must_have_one_slice_a_round():
    spec = rounds.RoundSpec(**{**torch_runs.BASE, "n_clients": C})
    params, _ = _cpu_inputs()
    with pytest.raises(ValueError, match="leading dims"):
        rounds.run_blade_fl(mlp_client_losses, spec, params,
                            batch_from_numpy(_stacked_batch(), "cpu"), K + 1,
                            device="cpu", stacked=True)


def test_graph_driver_needs_the_card():
    spec = rounds.RoundSpec(**{**torch_runs.BASE, "n_clients": C})
    params, batch = _cpu_inputs()
    with pytest.raises(ValueError, match="runs on the card"):
        rounds.run_blade_fl_scan(mlp_client_losses, spec, params, batch, K,
                                 device="cpu")
    with pytest.raises(TypeError, match="static batch"):
        rounds.run_blade_fl_scan(mlp_client_losses, spec, params,
                                 lambda k: batch, K, device="cpu")


@pytest.mark.parametrize("device,batches,jit,driver,reason", [
    ("cpu", "static", True, "loop", "CPU run"),
    ("cpu", "stacked", True, "loop", "CPU run"),
    ("cuda", "callable", True, "loop", "callable"),
    ("cuda", "static", False, "loop", "jit=False"),
    ("cuda", "static", True, "graph", "CUDA graphs"),
    ("cuda", "stacked", True, "graph", "CUDA graphs"),
    ("cuda:0", "static", True, "graph", "CUDA graphs"),
])
def test_dispatch_plan_picks_the_driver(device, batches, jit, driver,
                                        reason):
    spec = rounds.RoundSpec(n_clients=C, tau=1, eta=0.1,
                            topology=topology.from_name("rotate"))
    batch = {"x": torch.zeros((K, C, 2) if batches == "stacked" else (C, 2))}
    plan = rounds.dispatch_plan(
        spec, device, (lambda k: batch) if batches == "callable" else batch,
        jit=jit)
    assert plan["driver"] == driver and reason in plan["reason"]
    assert plan["pow"] == ("plain" if device == "cpu" else "kernel")
    assert plan["mix_mode"] == topology.EXEC_SHIFT_TABLE


def test_variants_follow_the_shift_phase_and_the_eval_stride():
    spec = rounds.RoundSpec(**{**torch_runs.BASE, "n_clients": C,
                               "topology": topology.from_name("rotate"),
                               "eval_every": 2})
    params, _ = _cpu_inputs()
    runner = rounds.RoundRunner(mlp_client_losses, spec, params, 6,
                                device="cpu")
    period = runner.plan.period
    assert period == jtopology.GossipRotation().period(C) > 1
    assert [runner.variant(k) for k in range(6)] == \
        [(k % period, (k + 1) % 2 == 0) for k in range(6)]
