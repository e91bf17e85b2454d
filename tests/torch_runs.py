"""Whole-run comparison helpers of the port's tests (not a test module).

The same MLP params and batch (numpy, from a seed) go through the JAX
package's per-round loop (``run_blade_fl`` with a batch callable, so never
its scan engine) and through the port's ``run_blade_fl`` on the CPU.
Per-round losses and divergence and the final params hold to rtol 1e-4 /
atol 1e-5: fp32 matmuls and reductions run in another order and the
differences compound over tau * K steps. Import after
``pytest.importorskip("torch")``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import rounds as jrounds
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.core import rounds
from repro_torch.models.mlp import mlp_client_losses
from repro_torch.weights import batch_from_numpy, params_from_jax

RTOL, ATOL = 1e-4, 1e-5
HIDDEN, M, TAU, K = 32, 16, 2, 3
BASE = dict(tau=TAU, eta=0.1, n_lazy=1, sigma2=0.0, mine_attempts=256,
            difficulty_bits=2)


def inputs(c, seed=0):
    """Reference MLP params (hidden 32) and a [C, 16] batch, as numpy."""
    params = {k: np.asarray(v) for k, v in
              jinit_mlp(jax.random.key(seed), hidden=HIDDEN).items()}
    rng = np.random.default_rng(seed)
    batch = {"x": rng.uniform(0, 1, (c, M, 784)).astype(np.float32),
             "y": rng.integers(0, 10, (c, M)).astype(np.int32)}
    return params, batch


def specs(c, jax_fields=None, torch_fields=None, **common):
    """(reference RoundSpec, port RoundSpec) with the shared fields plus
    each package's own objects (topologies, attacks)."""
    base = dict(BASE, n_clients=c, **common)
    return (jrounds.RoundSpec(**base, **(jax_fields or {})),
            rounds.RoundSpec(**base, **(torch_fields or {})))


def reference_matrices(topo, c, key, k):
    """The ``[K, C, C]`` matrices the reference's communicate stage draws
    in a run keyed by ``key``: its topology stream, at each round index."""
    keys = jrounds.topology_keys(key, k)
    return np.stack([np.asarray(topo.matrix(c, key=keys[t], round_idx=t))
                     for t in range(k)])


def run_pair(jspec, spec, k=K, key_seed=1, inject_matrices=False):
    """Run both packages on the same inputs; returns ((jstate, jhist,
    jledger), (state, hist, ledger)). ``inject_matrices`` hands the port
    the reference's per-round W of a stochastic topology."""
    c = spec.n_clients
    params, batch = inputs(c)
    key = jax.random.key(key_seed)
    jbatch = {n: jnp.asarray(v) for n, v in batch.items()}
    ref = jrounds.run_blade_fl(
        jmlp_loss, jspec, {n: jnp.asarray(v) for n, v in params.items()},
        lambda _: jbatch, key, k)
    mats = (reference_matrices(jspec.topology, c, key, k)
            if inject_matrices else None)
    got = rounds.run_blade_fl(
        mlp_client_losses, spec, params_from_jax(params, "cpu"),
        batch_from_numpy(batch, "cpu"), k, device="cpu",
        topology_matrices=mats)
    return ref, got


def assert_runs_close(ref, got, keys=("local_loss_mean", "global_loss",
                                      "divergence")):
    (jstate, jhist, jledger), (state, hist, ledger) = ref, got
    assert len(hist) == len(jhist)
    for k, (h, jh) in enumerate(zip(hist, jhist)):
        for name in keys:
            np.testing.assert_allclose(h[name], jh[name], rtol=RTOL,
                                       atol=ATOL, equal_nan=True,
                                       err_msg=f"round {k} {name}")
    for name, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert ledger.validate_chain() and jledger.validate_chain()
    assert len(ledger.blocks) == len(jledger.blocks)


def stage_loop(loss_fn, spec, params_single, batch, k, seed=0,
               topology_matrices=None):
    """The port's loop before its round became a step over static buffers:
    ``make_integrated_round`` over a ``RoundState`` in a Python loop, every
    stage drawing its noise from the run's generator round by round, the
    matrix ``table[t % M]`` and the nonce offset from the host's round
    index; on the CPU. Returns (state, history, ledger) like
    ``run_blade_fl``."""
    table = rounds.mix_matrices(spec, k, seed, "cpu", topology_matrices)
    state = rounds.init_state(params_single, spec.n_clients,
                              torch.Generator().manual_seed(seed))
    round_fn = rounds.make_integrated_round(loss_fn, spec, n_rounds=k,
                                            device="cpu")
    per_round = []
    for t in range(k):
        state, metrics = round_fn(
            state, batch, None if table is None else table[t % len(table)])
        per_round.append(metrics)
    rows = {n: torch.stack([m[n] for m in per_round]) for n in per_round[0]}
    history, ledger = rounds.history_and_ledger(rows)
    return state, history, ledger


def assert_runs_bitwise(want, got):
    """Two port runs (state, history, ledger) agree bit for bit."""
    (wstate, whist, wledger), (state, hist, ledger) = want, got
    assert state.round_idx == wstate.round_idx
    assert set(state.params) == set(wstate.params)
    for name, v in state.params.items():
        assert torch.equal(v, wstate.params[name]), name
    assert torch.equal(state.prev_hash, wstate.prev_hash)
    assert [list(h) for h in hist] == [list(h) for h in whist]
    for h, wh in zip(hist, whist):
        np.testing.assert_array_equal(np.array(list(h.values())),
                                      np.array(list(wh.values())))
    assert ledger.validate_chain()
    assert ledger.blocks == wledger.blocks
