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
from repro.core import mining as jmining
from repro.core import rounds as jrounds
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.core import dp, lazy, mining, rounds
from repro_torch.kernels.pow_hash import ref as pow_ref
from repro_torch.launch import train
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.weights import batch_from_numpy, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

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
    jspec = jrounds.RoundSpec(**base)
    # the port's mine kernel picks its own nonce tile (ops.race_tile)
    base.pop("mine_chunk", None)
    return jspec, rounds.RoundSpec(**base)


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


def _jax_mine(n_clients, attempts, chunk, use_kernel, bits=4):
    """The JAX package's stage as its tests run it: the Pallas race in
    interpret mode, or the per-client ``fori_loop`` search."""
    jspec = jrounds.RoundSpec(n_clients=n_clients, tau=TAU, eta=0.1,
                              mine_attempts=attempts, mine_chunk=chunk,
                              difficulty_bits=bits, use_kernel=use_kernel,
                              kernel_interpret=True)
    return jax.jit(jrounds.make_mine(jspec))


def _assert_stage_equal(got, jgot):
    (m, new), (jm, jnew) = got, jgot
    assert int(new) == int(jnew)
    assert sorted(m) == sorted(jm)
    for key in ("winner", "pow_hash", "nonce", "solved"):
        assert int(m[key]) == int(jm[key]), key
    assert m["solved"].dtype == torch.bool
    assert all(m[k].dtype == torch.int64 and m[k].dim() == 0
               for k in ("winner", "pow_hash", "nonce"))
    assert new.dtype == torch.int64 and new.dim() == 0


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "fori"])
@pytest.mark.parametrize("n_clients", [1, 7, 20])
@pytest.mark.parametrize("attempts,chunk", [(300, 128), (257, 64)])
def test_mine_seal_ref_matches_reference_make_mine(use_kernel, n_clients,
                                                    attempts, chunk):
    """The plain twin of the seal kernel, and the port's stage built on it,
    against the JAX stage at non-divisible budgets; the nonce offset
    ``round_idx * 2**20`` wraps past 2**32 from round 4096 on."""
    jmine = _jax_mine(n_clients, attempts, chunk, use_kernel)
    _, spec = _specs(n_clients=n_clients, mine_attempts=attempts,
                     mine_chunk=chunk, difficulty_bits=4)
    mine = rounds.make_mine(spec)
    rng = np.random.default_rng(100 * n_clients + attempts)
    for round_idx in (0, 3, 4095, 4096, 4097):
        prev, digest = (int(v) for v in rng.integers(0, 2 ** 32, 2))
        jgot = jmine(jnp.uint32(prev), jnp.uint32(digest),
                     jnp.int32(round_idx))
        off = mining.as_word((round_idx << 20) & mining.MASK)
        _assert_stage_equal(pow_ref.mine_seal_ref(
            mining.as_word(prev), mining.as_word(digest), off, n_clients,
            attempts, 4), jgot)
        _assert_stage_equal(mine(mining.as_word(prev),
                                 mining.as_word(digest), round_idx), jgot)


def test_mine_stage_keeps_nonce_zero_when_no_hash_beats_max(monkeypatch):
    """Every hash forced to 0xFFFFFFFF, as in test_torch_mining's race test:
    the JAX stage's fori_loop path and the port's stage both pick client 0
    with nonce 0, and the link takes nonce 0."""
    monkeypatch.setattr(jmining, "mix_hash",
                        lambda p, q, n: jnp.full(jnp.shape(n), 0xFFFFFFFF,
                                                 jnp.uint32))
    monkeypatch.setattr(mining, "mix_hash",
                        lambda p, q, n: torch.full(torch.broadcast_shapes(
                            p.shape, q.shape, n.shape), mining.MASK,
                            dtype=torch.int64))
    jgot = _jax_mine(7, 300, 128, False, bits=0)(
        jnp.uint32(5), jnp.uint32(6), jnp.int32(9))
    _, spec = _specs(n_clients=7, mine_attempts=300, difficulty_bits=0)
    got = rounds.make_mine(spec)(mining.as_word(5), mining.as_word(6), 9)
    _assert_stage_equal(got, jgot)
    assert (int(got[0]["winner"]), int(got[0]["nonce"])) == (0, 0)
    assert bool(got[0]["solved"])


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "fori"])
def test_mine_stage_on_a_real_max_hash(use_kernel):
    """A digest whose one salted hash is 0xFFFFFFFF (C = 1, one attempt),
    through the Pallas kernel as well: no monkeypatch reaches it."""
    prev, round_idx = 0xC0FFEE, 5
    off = (round_idx << 20) & mining.MASK
    salt = int(mining.client_salt(mining.as_word(0)))
    digest = pow_ref.payload_hashing_to(prev, off, mining.MASK) ^ salt
    jgot = _jax_mine(1, 1, 16, use_kernel)(
        jnp.uint32(prev), jnp.uint32(digest), jnp.int32(round_idx))
    _, spec = _specs(n_clients=1, mine_attempts=1, difficulty_bits=4)
    got = rounds.make_mine(spec)(mining.as_word(prev),
                                 mining.as_word(digest), round_idx)
    _assert_stage_equal(got, jgot)
    assert int(got[0]["pow_hash"]) == mining.MASK
    assert int(got[0]["nonce"]) == 0 and not bool(got[0]["solved"])


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
    # the reference's run_mlp keys
    assert set(result) == {"K", "tau", "final_eval_loss", "final_eval_acc",
                           "final_global_loss", "chain_valid", "blocks",
                           "devices", "fast_allreduce", "dispatch", "wall_s",
                           "spectral_gap_mean", "spectral_gap_min",
                           "ergodic_gap", "predicted_consensus_rate"}
    assert result["devices"] == 1 and result["fast_allreduce"] is False
    assert result["dispatch"] == {
        "driver": "loop", "pow": "plain", "mix": "jnp",
        "mix_mode": "exec_fedavg", "reason": result["dispatch"]["reason"]}
    assert result["spectral_gap_min"] == pytest.approx(1.0)
    assert result["chain_valid"] and result["blocks"] == 2
    assert result["tau"] == 2 and np.isfinite(result["final_global_loss"])
