"""The port's integrated round against the JAX package's, on the CPU.

The same params (``params_from_jax``) and batch (numpy) go through JAX
``rounds.run_blade_fl`` and the port's. Per-round losses, divergence and
the final params hold to rtol 1e-4 / atol 1e-5: every GD step takes fp32
matmuls and reductions in another order, and those differences compound
over tau * K steps. The digest is tolerance tier (its leaf sums are
associated differently), so the ledgers fork while both validate; given
the reference's digests, the mine stage is bitwise.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import dp as jdp
from repro.core import lazy as jlazy
from repro.core import rounds as jrounds
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.core import dp, lazy, mining, rounds
from repro_torch.launch import train
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.weights import batch_from_numpy, params_from_jax

RTOL, ATOL = 1e-4, 1e-5
C, HIDDEN, M, TAU, K = 4, 32, 16, 2, 3


def _inputs(seed=0):
    params = {k: np.asarray(v) for k, v in
              jinit_mlp(jax.random.key(seed), hidden=HIDDEN).items()}
    rng = np.random.default_rng(seed)
    batch = {"x": rng.uniform(0, 1, (C, M, 784)).astype(np.float32),
             "y": rng.integers(0, 10, (C, M)).astype(np.int32)}
    return params, batch


def _specs(**kw):
    base = dict(n_clients=C, tau=TAU, eta=0.1, n_lazy=1, sigma2=0.0,
                mine_attempts=256, difficulty_bits=2)
    base.update(kw)
    return jrounds.RoundSpec(**base), rounds.RoundSpec(**base)


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("eval_every", [1, 2])
def test_run_blade_fl_matches_reference(eval_every):
    params, batch = _inputs()
    jspec, spec = _specs(eval_every=eval_every)
    jstate, jhist, jledger = jrounds.run_blade_fl(
        jmlp_loss, jspec, _jnp(params), _jnp(batch), jax.random.key(1), K)
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params_from_jax(params, "cpu"),
        batch_from_numpy(batch, "cpu"), K, device="cpu")
    assert len(hist) == len(jhist) == K
    for h, jh in zip(hist, jhist):
        for key in ("local_loss_mean", "global_loss", "divergence"):
            np.testing.assert_allclose(h[key], jh[key], rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=key)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert state.round_idx == K
    assert ledger.validate_chain() and jledger.validate_chain()
    assert len(ledger.blocks) == K
    # the carried prev_hash is the device-side link: mix_hash over the
    # rounds' digests and winning nonces, from the genesis hash
    prev = mining.as_word(rounds.chain.GENESIS_HASH)
    for h in hist:
        prev = mining.mix_hash(prev, mining.as_word(int(h["digest"])),
                               mining.as_word(int(h["nonce"])))
    assert int(state.prev_hash) == int(prev)


def test_local_train_stage_matches_reference():
    params, batch = _inputs(1)
    jspec, spec = _specs(tau=3)
    stacked = {k: np.stack([v] * C) for k, v in params.items()}
    stacked["w1"] = stacked["w1"] + np.random.default_rng(2).normal(
        size=stacked["w1"].shape).astype(np.float32) * 0.01
    jp, jl = jax.jit(jrounds.make_local_train(jmlp_loss, jspec))(
        _jnp(stacked), _jnp(batch))
    p, losses = rounds.make_local_train(mlp_client_losses, spec)(
        params_from_jax(stacked, "cpu"), batch_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_lazy,sigma2,dp_sigma",
                         [(1, 0.25, 0.0), (2, 0.01, 0.0), (1, 0.04, 0.1),
                          (0, 0.0, 0.2)])
def test_perturb_with_reference_draws(n_lazy, sigma2, dp_sigma):
    """Feed the reference's own per-leaf draws (one key per leaf, in
    jax.tree.leaves order) and get its broadcast set back."""
    jspec, spec = _specs(n_lazy=n_lazy, sigma2=sigma2, dp_sigma=dp_sigma)
    rng = np.random.default_rng(3)
    stacked = {k: rng.normal(size=(C,) + v.shape).astype(np.float32)
               for k, v in _inputs()[0].items()}
    k_lazy, k_dp = jax.random.split(jax.random.key(7))
    want, _ = jrounds.make_perturb(jspec)(_jnp(stacked), k_lazy, k_dp)

    def draws(key):
        keys = jax.random.split(key, len(stacked))
        return {k: torch.from_numpy(np.array(
            jax.random.normal(kk, stacked[k].shape, jnp.float32)))
            for k, kk in zip(sorted(stacked), keys)}

    got = rounds.make_perturb(spec)(
        params_from_jax(stacked, "cpu"), torch.Generator(),
        lazy_noise=draws(k_lazy), dp_noise=draws(k_dp))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if n_lazy and not dp_sigma:
        # honest rows pass through untouched
        np.testing.assert_array_equal(got["w1"][n_lazy:].numpy(),
                                      stacked["w1"][n_lazy:])


def test_dp_calibration_and_theta_match_reference():
    for eps, delta in [(0.5, 1e-5), (2.0, 1e-3)]:
        assert dp.gaussian_sigma(eps, delta) == jdp.gaussian_sigma(eps, delta)
        sigma = dp.gaussian_sigma(eps, delta)
        assert dp.epsilon_of_sigma(sigma, delta) == \
            jdp.epsilon_of_sigma(sigma, delta)
    with pytest.raises(ValueError):
        dp.gaussian_sigma(0.0, 1e-5)
    rng = np.random.default_rng(8)
    a = {k: rng.normal(size=(5, 3)).astype(np.float32) for k in ("u", "v")}
    b = {k: v + 0.1 for k, v in a.items()}
    want = jlazy.measure_theta(_jnp(a), _jnp(b))
    got = lazy.measure_theta({k: torch.from_numpy(v) for k, v in a.items()},
                             {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_perturb_draws_from_generator_only_when_active():
    _, spec = _specs(n_lazy=0)
    x = {"w": torch.ones((C, 3))}
    assert rounds.make_perturb(spec)(x, torch.Generator()) is x
    _, spec = _specs(n_lazy=2, sigma2=1.0)
    a = rounds.make_perturb(spec)(x, torch.Generator().manual_seed(5))
    b = rounds.make_perturb(spec)(x, torch.Generator().manual_seed(5))
    assert torch.equal(a["w"], b["w"])
    assert not torch.equal(a["w"][:2], x["w"][:2])
    assert torch.equal(a["w"][2:], x["w"][2:])


@pytest.mark.parametrize("attempts,chunk", [(256, 64), (1000, 384),
                                            (10240, 1024)])
def test_mine_with_reference_digest_is_bitwise(attempts, chunk):
    jspec, spec = _specs(n_clients=5, mine_attempts=attempts, mine_chunk=chunk,
                         difficulty_bits=4)
    jmine = jax.jit(jrounds.make_mine(jspec))
    mine = rounds.make_mine(spec)
    rng = np.random.default_rng(attempts)
    for round_idx in (0, 1, 4095, 4096):   # the offset wraps at 4096
        prev, digest = (int(v) for v in rng.integers(0, 2 ** 32, 2))
        jm, jnew = jmine(jnp.uint32(prev), jnp.uint32(digest),
                         jnp.int32(round_idx))
        m, new = mine(mining.as_word(prev), mining.as_word(digest), round_idx)
        assert int(new) == int(jnew)
        for key in ("winner", "pow_hash", "nonce", "solved"):
            assert int(m[key]) == int(jm[key]), key


def test_port_ledger_validates_and_tamper_fails():
    params, batch = _inputs(2)
    _, spec = _specs(difficulty_bits=0)
    _, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params_from_jax(params, "cpu"),
        batch_from_numpy(batch, "cpu"), 4, device="cpu")
    assert ledger.validate_chain() and len(ledger.blocks) == 4
    assert [b.model_digest for b in ledger.blocks] == \
        [int(h["digest"]) for h in hist]
    bumped = (ledger.blocks[1].model_digest + 1) & mining.MASK
    assert not ledger.tampered_copy(1, model_digest=bumped).validate_chain()


def test_run_blade_fl_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    params, batch = _inputs()
    _, spec = _specs()
    with pytest.raises(RuntimeError, match="cuda"):
        rounds.run_blade_fl(mlp_client_losses, spec,
                            params_from_jax(params, "cpu"),
                            batch_from_numpy(batch, "cpu"), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--k", "1"])


def test_train_entry_point_on_cpu_prints_the_reference_keys(capsys):
    result = train.run_mlp(train.build_parser().parse_args(
        ["--arch", "mlp", "--k", "2", "--clients", "3", "--t-sum", "24",
         "--lazy", "1", "--sigma2", "0.01", "--device", "cpu"]))
    printed = json.loads(capsys.readouterr().out)
    assert printed == result
    assert set(result) == {"K", "tau", "final_eval_loss", "final_eval_acc",
                           "final_global_loss", "chain_valid", "blocks",
                           "devices", "dispatch", "wall_s"}
    assert result["chain_valid"] and result["blocks"] == 2
    assert result["tau"] == 2 and np.isfinite(result["final_global_loss"])
