"""BLADE-FL rounds around the LM zoo in the port against the JAX package,
on the CPU: K = 2 rounds of xlstm-125m and deepseek-v2-236b smoke (the
archs of the reference's ``tests/test_e2e.py``), jamba-1.5-large-398b
(Mamba scan, GQA, MoE) and phi4-mini-3.8b (the slice trained at its
published widths on the card) from the reference's params and token
streams, the trainer's ``--arch`` run and its keys, phi4-mini's one-H100
config, the example, and the mesh-free ``launch/steps.py``.

Tolerance: rtol 1e-4 / atol 1e-5 on per-round losses, divergence and the
final params, as ``tests/torch_runs.py`` holds the MLP runs: the fp32
differences compound over tau * K steps. The ledger forks from the JAX
chain by the port's one diagnostic tier (``core/rounds.py``); both chains
must validate.
"""
import dataclasses
import importlib.util
import io
import json
import os
import types
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro_torch import configs, kernels, tree
from repro_torch.configs import base as configs_base
from repro_torch.core import rounds
from repro_torch.launch import steps, train
from repro_torch.models import registry
from repro_torch.weights import lm_params_from_jax

from torch_runs import lm_batch_to_torch
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 1e-4, 1e-5
K, C, PER_CLIENT, SEQ = 2, 2, 2, 16
# the reference's run_arch_smoke keys
REFERENCE_ARCH_KEYS = {"arch", "rounds", "loss_curve", "chain_valid",
                       "devices", "fast_allreduce", "dispatch", "wall_s",
                       "spectral_gap_mean",
                       "spectral_gap_min", "ergodic_gap",
                       "predicted_consensus_rate"}
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "torch_arch_fl_training.py")


def reference_lazy_noise(jparams, key, n_rounds, n_lazy):
    """The lazy clients' noise the reference's rounds draw, as the port's
    ``rounds.draw_noise`` lays it out (path -> ``[K, n_lazy, ...]``): round
    k's ``k_lazy`` from the run key's split chain, one key a leaf in
    ``jax.tree.leaves`` order, each draw shaped as the ``[C, ...]`` leaf
    and its first ``n_lazy`` rows kept."""
    leaves, treedef = jax.tree.flatten(jparams)
    draws = []
    for _ in range(n_rounds):
        key, k_lazy, _ = jax.random.split(key, 3)
        keys = jax.random.split(k_lazy, len(leaves))
        draws.append(tree.flatten(jax.tree.unflatten(treedef, [
            np.asarray(jax.random.normal(kk, (C,) + leaf.shape,
                                          np.float32))[:n_lazy]
            for leaf, kk in zip(leaves, keys)])))
    return {path: torch.from_numpy(np.stack([d[path] for d in draws]))
            for path in draws[0]}


@pytest.mark.parametrize("arch", ["xlstm-125m", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b", "phi4-mini-3.8b"])
def test_arch_rounds_match_reference(arch, monkeypatch):
    """The reference's ``run_arch_smoke`` round (tau 2, eta 1e-2, 256
    attempts, difficulty 2, one lazy client) at the card run's sigma2
    1e-4, over its stacked token streams, on its params; the port's
    ``run_blade_fl`` on the same params and streams, on the CPU's loop
    driver, reading the reference's lazy noise in place of its own
    ``draw_noise`` table."""
    jcfg, cfg = jconfigs.get_smoke_arch(arch), configs.get_smoke_arch(arch)
    shape = jconfigs.ShapeConfig("smoke", SEQ, C * PER_CLIENT, "train")
    jbatches = jpipeline.LMDataSource(jcfg, shape, C, seed=0) \
        .stacked_batches(K)
    jparams = jregistry.init_model(jax.random.key(0), jcfg)
    common = dict(n_clients=C, tau=2, eta=1e-2, n_lazy=1, sigma2=1e-4,
                  mine_attempts=256, difficulty_bits=2)
    key = jax.random.fold_in(jax.random.key(0), 2)
    jstate, jhist, jledger = jrounds.run_blade_fl(
        lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False),
        jrounds.RoundSpec(**common), jparams, jbatches, key, K,
        stacked=True)
    noise = reference_lazy_noise(jparams, key, K, common["n_lazy"])
    monkeypatch.setattr(rounds, "draw_noise",
                        lambda spec, params, n_rounds, generator, device:
                        {"lazy": noise})
    params = tree.flatten(lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    assert set(noise) == set(params)
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), rounds.RoundSpec(**common), params,
        lm_batch_to_torch(jbatches), K, device="cpu", stacked=True)
    assert len(hist) == len(jhist) == K
    for k, (h, jh) in enumerate(zip(hist, jhist)):
        for name in ("local_loss_mean", "global_loss", "divergence"):
            np.testing.assert_allclose(h[name], jh[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"round {k} {name}")
    jflat = tree.flatten(jax.tree.map(np.asarray, jstate.params))
    assert set(jflat) == set(state.params)
    for name, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), jflat[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert ledger.validate_chain() and jledger.validate_chain()
    assert len(ledger.blocks) == len(jledger.blocks) == K


def _train(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        train.main(argv + ["--device", "cpu"])
    return json.loads(out.getvalue())


def test_trainer_arch_run_prints_the_reference_keys():
    kernels.reset_launch_counts()
    result = _train(["--arch", "xlstm-125m", "--rounds", "2", "--clients",
                     "2", "--seq", "12", "--lazy", "1", "--sigma2", "1e-4"])
    assert REFERENCE_ARCH_KEYS <= set(result)
    assert result["arch"] == "xlstm-125m-smoke" and result["rounds"] == 2
    assert result["chain_valid"] and result["blocks"] == 2
    assert len(result["loss_curve"]) == 2
    assert all(np.isfinite(result["loss_curve"]))
    assert result["dispatch"]["driver"] == "loop"
    assert result["launches"] == {name: 0 for name in kernels.WRAPPERS}
    assert result["peak_mem_gb"] is None


def test_trainer_arch_run_is_seeded_and_takes_microbatches():
    """The same flags give the same losses; ``--microbatches 2`` gives
    the one-batch run's losses within the tolerance (the gradient is the
    mean over the microbatches either way, on equal-sized halves)."""
    flags = ["--arch", "phi4-mini-3.8b", "--rounds", "2", "--clients", "2",
             "--seq", "8", "--eval-every", "2"]
    first, again = _train(flags), _train(flags)
    assert first["loss_curve"] == again["loss_curve"]
    assert np.isnan(first["loss_curve"][0])
    halves = _train(flags + ["--microbatches", "2"])
    np.testing.assert_allclose(halves["loss_curve"][1],
                               first["loss_curve"][1], rtol=RTOL, atol=ATOL)


def test_trainer_refuses_an_unknown_arch_and_cohorts_of_an_lm():
    for argv in (["--arch", "gpt-5"],
                 ["--arch", "xlstm-125m", "--enrolled", "10"]):
        with pytest.raises(SystemExit):
            train.main(argv + ["--device", "cpu"])
    # an arch module with no one-H100 config (every arch of the zoo has
    # one): the trainer raises before it draws a param
    full = configs.get_arch("nemotron-4-15b")
    bare = types.SimpleNamespace(CONFIG=full, SMOKE=full)
    with mock.patch.object(configs_base, "_arch_module",
                           lambda arch_id: bare), \
            pytest.raises(ValueError, match="one-H100"):
        _train(["--arch", "nemotron-4-15b", "--size", "one-h100"])


def test_phi4_one_h100_config_keeps_the_published_widths():
    """``--size one-h100`` reaches phi4-mini's ONE_H100: the published
    config less 30 of its 32 layers, 0.816 G parameters (the tied
    embedding 0.615 G and two layers of 0.101 G), reckoned without
    allocating them."""
    cut = configs.get_one_h100_arch("phi4-mini-3.8b")
    full = configs.get_arch("phi4-mini-3.8b")
    assert dataclasses.replace(cut, name=full.name, n_layers=32) == full
    assert (cut.n_layers, cut.d_model, cut.n_heads, cut.n_kv_heads,
            cut.resolved_head_dim, cut.d_ff, cut.vocab, cut.mlp,
            cut.tie_embeddings) == (2, 3072, 24, 8, 128, 8192, 200_064,
                                    "swiglu", True)
    d = cut.d_model
    layer = (2 * d + d * 24 * 128 + 2 * d * 8 * 128 + 24 * 128 * d
             + 3 * d * 8192)
    assert cut.param_count() == 200_064 * d + d + 2 * layer == 815_938_560
    parser = train.build_parser()
    args = parser.parse_args(["--arch", "phi4-mini-3.8b", "--size",
                              "one-h100"])
    assert args.size == "one-h100"


def test_example_trains_and_chains_at_a_tiny_size():
    spec = importlib.util.spec_from_file_location("torch_arch_fl_training",
                                                  EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    with redirect_stdout(out):
        state, hist, ledger = example.main(
            ["--device", "cpu", "--rounds", "2", "--tau", "1", "--seq", "8",
             "--clients", "2"])
    text = out.getvalue()
    assert text.startswith("xlstm-125m-smoke:")
    assert "chain valid: True (2 blocks)" in text
    assert len(hist) == 2 and ledger.validate_chain()


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-32b", "long_500k"), ("xlstm-125m", "long_500k"),
    ("hubert-xlarge", "decode_32k"), ("phi4-mini-3.8b", "train_4k")])
def test_steps_resolve_cfg_and_skip_reason_match_reference(arch, shape):
    jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    jshape, shp = jconfigs.get_shape(shape), configs.get_shape(shape)
    assert dataclasses.asdict(steps.resolve_cfg(cfg, shp)) \
        == dataclasses.asdict(jsteps.resolve_cfg(jcfg, jshape))
    assert steps.skip_reason(cfg, shp) == jsteps.skip_reason(jcfg, jshape)


@pytest.mark.parametrize("batch,clients,fsdp", [
    (256, 16, ()), (64, 4, ()), (8, 8, ()), (256, 2, ("data",))])
def test_round_spec_for_takes_the_references_microbatch_rule(batch,
                                                             clients, fsdp):
    """The reference's rule on the plan: 8 samples a microbatch, 32 under
    FSDP axes (256 / 2 clients: 4 microbatches, not 16)."""
    from repro.sharding.specs import ShardingPlan as JShardingPlan
    from repro_torch.sharding.specs import ShardingPlan

    cfg = configs.get_arch("phi4-mini-3.8b")
    shp = configs.ShapeConfig("t", 4096, batch, "train")
    client_axes = () if fsdp else ("data",)
    spec = steps.round_spec_for(cfg, shp, ShardingPlan(
        clients, client_axes, fsdp, fsdp_axes=fsdp))
    want = jsteps.round_spec_for(jconfigs.get_arch("phi4-mini-3.8b"),
                                 jconfigs.ShapeConfig("t", 4096, batch,
                                                      "train"),
                                 JShardingPlan(clients, client_axes, fsdp,
                                               fsdp_axes=fsdp))
    assert spec.microbatches == (4 if fsdp else max(1, batch // clients // 8))
    for field in ("n_clients", "tau", "eta", "n_lazy", "sigma2",
                  "mine_attempts", "difficulty_bits", "microbatches",
                  "eval_global_loss"):
        assert getattr(spec, field) == getattr(want, field), field
