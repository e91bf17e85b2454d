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


# ---------------------------------------------------------------------------
# LM training: the loss and its gradients of one smoke arch
# ---------------------------------------------------------------------------

# rtol / atol on the loss and on non-recurrent archs' gradients: the same
# fp32 ops summed in another order; the recurrent archs' gradients (the
# xLSTM and Mamba time loops) at tests/test_torch_xlstm.py's atol 3e-5 /
# rtol 1e-4
LM_TOL = 1e-5
RECURRENT_ATOL, RECURRENT_RTOL = 3e-5, 1e-4
RECURRENT_ARCHS = ("xlstm-125m", "jamba-1.5-large-398b")
LM_SHAPE = (24, 2)   # (seq, batch) of the loss tests


def lm_batch_to_torch(batch):
    """A reference LM batch (numpy or jax leaves) as port tensors: floats
    as float32, bools as bool, integers as int64; any leading axes."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            out[k] = torch.from_numpy(v.copy())
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = torch.from_numpy(v.astype(np.int64))
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32))
    return out


def assert_loss_and_grads_match(arch, seed=0):
    """``train_loss`` and its gradient with respect to every leaf, of the
    arch's smoke config on the reference's params and batch, against the
    JAX package's ``value_and_grad`` of its ``train_loss``; the metrics
    (``ce``, ``aux``) too. The port runs with remat (recomputing each
    period in the backward pass), the reference without."""
    from repro import configs as jconfigs
    from repro.models import registry as jregistry
    from repro.models import transformer as jtransformer
    from repro_torch import configs, tree
    from repro_torch.models import transformer
    from repro_torch.weights import lm_params_from_jax

    jcfg, cfg = jconfigs.get_smoke_arch(arch), configs.get_smoke_arch(arch)
    jparams = jtransformer.init_lm(jax.random.key(seed), jcfg)
    seq, b = LM_SHAPE
    jbatch = jregistry.make_train_batch(
        jax.random.key(seed + 1), jcfg,
        jconfigs.ShapeConfig("t", seq, b, "train"))
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.train_loss(p, jcfg, jbatch, remat=False),
        has_aux=True))(jparams)
    flat = tree.flatten(lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                           "cpu"))
    leaves = {k: v.requires_grad_(True) for k, v in flat.items()}
    loss, metrics = transformer.train_loss(
        tree.unflatten(leaves), cfg, lm_batch_to_torch(jbatch), remat=True)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LM_TOL, atol=LM_TOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(jmetrics[name]), rtol=LM_TOL,
                                   atol=LM_TOL, err_msg=name)
    if arch in RECURRENT_ARCHS:
        rtol, atol = RECURRENT_RTOL, RECURRENT_ATOL
    else:
        rtol = atol = LM_TOL
    jflat = tree.flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(leaves)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=rtol,
                                   atol=atol, err_msg=f"{arch} grad {name}")
    return float(metrics["aux"].detach())
