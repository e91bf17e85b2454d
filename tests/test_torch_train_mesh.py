"""The BLADE-FL train step on a (data, model) mesh (``launch/steps.py::
build_train_step``, the L1 layout), over gloo ranks on the CPU, against
the one-process port and the JAX package.

Two worlds: 4 ranks as (data 2, model 2), and 2 ranks as (1, 2) and (2,
1). Each rank runs the step on its blocks (the clients over data, each
client's params over model) and the blocks are put back together by
``specs.gather_tree``, which also checks that the replicas of every leaf
the plan does not split agree bitwise across the ranks.

- The tensor-parallel loss and its gradients (the differentiable
  collectives of ``models/parallel.py`` and the vocab-parallel
  cross-entropy) for phi4-mini, qwen3 (qk-norm), minicpm (tied head) and
  nemotron (squared ReLU) smoke at (1, 2) and (2, 2), and a cut head (3
  query heads over 2 ranks: q, k and v gathered, the gather's backward
  the rank's block of the summed gradient), held to the one-process port
  and to ``jax.grad`` of the reference's loss on the same params
  (``weights.lm_params_from_jax``): losses at rtol 1e-5, gradients at
  rtol 1e-4 / atol 1e-5.
- K = 2 rounds of phi4-mini smoke at (2, 2), C = 4, one lazy client,
  against the one-process port's rounds and the reference's
  ``run_blade_fl`` fed the same lazy noise: params, per-round losses and
  divergence at rtol 1e-4 / atol 1e-5, both ledgers valid, the
  replicated leaves bitwise across the model ranks. The psum tier with 2
  microbatches (the checkpointed microbatch re-runs the forward's
  collectives in the backward), and ``random:0.5 --fused-mix`` (a
  matrix a round), against the one-process port.
- At (2, 1) the step is the client-sharded engine: phi4-mini and
  xlstm-125m smoke bitwise the one-process run (params, history,
  ledger), the noise drawn by the step round by round.
- The communicate stage on model blocks: the digest bitwise the fold of
  the blocks' fixed-order sums, the divergence within rtol 1e-6 of one
  process's, fedavg and the ring's halo the one-process mixes' blocks
  bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist
from repro import configs as jconfigs
from repro.core import rounds as jrounds
from repro.models import registry as jregistry
from repro_torch import tree
from repro_torch.configs import get_smoke_arch
from repro_torch.core import mining, rounds, topology
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg.ref import digest_div_flat_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.sharding import specs
from repro_torch.sharding.specs import ShardingPlan
from repro_torch.weights import lm_params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
M, SEQ = 2, 16          # samples a client, tokens a sample
K = 2

GRAD_ARCHS = ["phi4-mini-3.8b", "qwen3-32b", "minicpm-2b", "nemotron-4-15b"]
# name -> (arch, config changes, mesh)
GRAD_CASES = {f"{a} {m}": (a, {}, m) for a in GRAD_ARCHS
              for m in ((1, 2), (2, 2))}
GRAD_CASES["cut heads (1, 2)"] = ("phi4-mini-3.8b",
                                  {"n_heads": 3, "n_kv_heads": 3}, (1, 2))
GRAD_CLIENTS = 2

# the reference's run_arch_smoke round at one lazy client (as
# tests/test_torch_arch_fl.py runs it)
ROUND = dict(tau=2, eta=1e-2, n_lazy=1, sigma2=1e-4, mine_attempts=256,
             difficulty_bits=2)
# name -> (arch, mesh, C, round spec changes, the reference's noise)
ROUND_CASES = {
    "phi4 (2, 2)": ("phi4-mini-3.8b", (2, 2), 4, {}, True),
    "phi4 psum (2, 2)": ("phi4-mini-3.8b", (2, 2), 4,
                         {"fast_allreduce": True, "microbatches": 2}, False),
    # the dense mix on mix_rows_flat's plain twin (R = C/D, K = C) on
    # each model block, a matrix a round handed to the step
    "phi4 random:0.5 fused (2, 2)": (
        "phi4-mini-3.8b", (2, 2), 4,
        {"topology": topology.from_name("random:0.5"), "fused_mix": True},
        False),
    "phi4 (2, 1)": ("phi4-mini-3.8b", (2, 1), 2, {}, False),
    "xlstm (2, 1)": ("xlstm-125m", (2, 1), 2, {}, False),
}
BITWISE = ("phi4 (2, 1)", "xlstm (2, 1)")
STEP_SEED = 3
STAGE_CLIENTS = 4
# the ring's halo: block shifts between the data ranks of a model
# coordinate (ClientMesh.view maps the view's ranks to the world's)
RING = rounds.RoundSpec(n_clients=STAGE_CLIENTS, tau=1, eta=0.1,
                        topology=topology.from_name("ring"))


def _seed(name):
    return sum(map(ord, name))


def _cfgs(arch, over):
    return (dataclasses.replace(get_smoke_arch(arch), **over),
            dataclasses.replace(jconfigs.get_smoke_arch(arch), **over))


def _jparams(jcfg, seed):
    return jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(seed), jcfg))


def _flat_port(jparams):
    return {k: v.numpy() for k, v in
            tree.flatten(lm_params_from_jax(jparams, "cpu")).items()}


def _replicated(flat, c):
    return {k: torch.from_numpy(np.repeat(v[None], c, axis=0))
            for k, v in flat.items()}


def reference_lazy_noise(jparams, key, n_rounds, n_lazy, c):
    """The lazy clients' noise the reference's rounds draw (path -> [K,
    n_lazy, ...]): round k's ``k_lazy`` from the run key's split chain,
    one key a leaf in ``jax.tree.leaves`` order, each draw shaped as the
    ``[C, ...]`` leaf and its first ``n_lazy`` rows kept."""
    leaves, treedef = jax.tree.flatten(jparams)
    draws = []
    for _ in range(n_rounds):
        key, k_lazy, _ = jax.random.split(key, 3)
        keys = jax.random.split(k_lazy, len(leaves))
        draws.append(tree.flatten(jax.tree.unflatten(treedef, [
            np.asarray(jax.random.normal(kk, (c,) + leaf.shape,
                                          np.float32))[:n_lazy]
            for leaf, kk in zip(leaves, keys)])))
    return {path: np.stack([d[path] for d in draws]) for path in draws[0]}


def _grad_want(cfg, jcfg, jparams, tokens):
    """The one-process port's and the reference's per-client losses and
    gradients ([C, ...] a leaf) on the same params and tokens."""
    flat = _flat_port(jparams)
    c = tokens.shape[0]
    full = {k: v.requires_grad_(True) for k, v in _replicated(flat, c).items()}
    keys = sorted(full)
    losses = registry.client_losses(cfg)(
        full, {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    grads = torch.autograd.grad(losses.sum(), [full[k] for k in keys])
    port = (losses.detach().numpy(),
            {k: g.numpy() for k, g in zip(keys, grads)})

    def one(p, t):
        return jregistry.loss_fn(p, jcfg, {"tokens": t}, remat=False)[0]

    value_and_grad = jax.jit(jax.value_and_grad(one))
    jl, jg = [], []
    for i in range(c):
        loss, g = value_and_grad(jparams, tokens[i])
        jl.append(float(loss))
        jg.append(tree.flatten(jax.tree.map(np.asarray, g)))
    ref = (np.array(jl), {k: np.stack([g[k] for g in jg]) for k in jg[0]})
    return port, ref


def _round_inputs(name):
    arch, mesh, c, over, ref_noise = ROUND_CASES[name]
    cfg, jcfg = _cfgs(arch, {})
    seed = _seed(name)
    jparams = _jparams(jcfg, seed)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (K, c, M, SEQ)).astype(np.int32)
    spec = rounds.RoundSpec(n_clients=c, **{**ROUND, **over})
    return cfg, jcfg, jparams, tokens, spec


def _one_process_rounds(cfg, spec, flat, tokens, noise, matrices,
                        monkeypatch):
    """The one-process port's K rounds (the loop driver on the CPU), with
    the reference's lazy noise in place of its own draws and the given
    mixing matrices, when given."""
    if noise is not None:
        monkeypatch.setattr(rounds, "draw_noise",
                            lambda *a, **kw: {"lazy": {
                                k: torch.from_numpy(v)
                                for k, v in noise.items()}})
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec,
        {k: torch.from_numpy(v) for k, v in flat.items()},
        {"tokens": torch.from_numpy(tokens.astype(np.int64))}, K,
        seed=STEP_SEED, device="cpu", stacked=True,
        topology_matrices=matrices)
    monkeypatch.undo()
    return ({k: v.numpy() for k, v in state.params.items()}, hist,
            [b.header_hash for b in ledger.blocks], ledger.validate_chain())


def _reference_rounds(jcfg, jparams, tokens, spec_kw, key):
    jstate, jhist, jledger = jrounds.run_blade_fl(
        lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False),
        jrounds.RoundSpec(**spec_kw), jparams, {"tokens": tokens}, key, K,
        stacked=True)
    return (tree.flatten(jax.tree.map(np.asarray, jstate.params)), jhist,
            jledger.validate_chain())


def _stage_params():
    """[C, ...] leaves of phi4-mini smoke's shapes, N(0, 1) from a seed."""
    cfg = get_smoke_arch("phi4-mini-3.8b")
    flat = tree.flatten(registry.init_model(torch.Generator(), cfg))
    rng = np.random.default_rng(7)
    return {k: rng.standard_normal((STAGE_CLIENTS,) + tuple(v.shape))
            .astype(np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def trained(monkeypatch_module):
    """Every case on its mesh (a world of 4 ranks, one of 2), with the
    one-process port's and the reference's results."""
    worlds = {4: {}, 2: {}}
    wants = {}
    for name, (arch, over, mesh) in GRAD_CASES.items():
        cfg, jcfg = _cfgs(arch, over)
        seed = _seed(f"{arch} {over}")
        jparams = _jparams(jcfg, seed)
        tokens = np.random.default_rng(seed).integers(
            0, cfg.vocab, (GRAD_CLIENTS, M, SEQ)).astype(np.int32)
        worlds[mesh[0] * mesh[1]][name] = {
            "kind": "grad", "cfg": cfg, "mesh": mesh,
            "plan": ShardingPlan(GRAD_CLIENTS, ("data",), ()),
            "params": _flat_port(jparams), "tokens": tokens}
        key = (arch, str(over))
        if key not in wants:
            wants[key] = _grad_want(cfg, jcfg, jparams, tokens)
        wants[name] = wants[key]
    for name, (arch, mesh, c, over, ref_noise) in ROUND_CASES.items():
        cfg, jcfg, jparams, tokens, spec = _round_inputs(name)
        flat = _flat_port(jparams)
        noise = ref = None
        if ref_noise:
            key = jax.random.fold_in(jax.random.key(0), 2)
            noise = reference_lazy_noise(jparams, key, K, spec.n_lazy, c)
            ref = _reference_rounds(jcfg, jparams, tokens,
                                    dict(n_clients=c, **ROUND), key)
        matrices = rounds.mix_matrices(spec, K, STEP_SEED, "cpu")
        if matrices is not None:
            matrices = matrices.numpy()
        worlds[mesh[0] * mesh[1]][name] = {
            "kind": "rounds", "cfg": cfg, "mesh": mesh, "spec": spec,
            "plan": ShardingPlan(c, ("data",), ()), "params": flat,
            "tokens": tokens, "seed": STEP_SEED, "matrices": matrices,
            "noise": None if noise is None else [
                {"lazy": {k: v[i] for k, v in noise.items()}}
                for i in range(K)]}
        wants[name] = (_one_process_rounds(cfg, spec, flat, tokens, noise,
                                           matrices, monkeypatch_module),
                       ref)
    worlds[4]["stage"] = {
        "kind": "stage", "cfg": get_smoke_arch("phi4-mini-3.8b"),
        "mesh": (2, 2), "params": _stage_params(),
        "plan": ShardingPlan(STAGE_CLIENTS, ("data",), ()),
        "spec": rounds.RoundSpec(n_clients=STAGE_CLIENTS, tau=1, eta=0.1),
        "more_specs": [RING],
        "tokens": np.zeros((STAGE_CLIENTS, M, SEQ), np.int32)}
    got = {}
    for n, jobs in worlds.items():
        ranks = mesh_lib.run_world(torch_dist.train_mesh_rank, n,
                                   backend="gloo", device="cpu",
                                   args=(jobs,))
        for name, job in jobs.items():
            got[name] = (job, [r[name] for r in ranks])
    return got, wants


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _gathered(job, blocks, key):
    mesh = specs.MeshShape(("data", "model"), job["mesh"])
    return specs.gather_tree(
        [{k: torch.from_numpy(v) for k, v in b[key].items()}
         for b in blocks], blocks[0]["specs"], mesh)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_tensor_parallel_loss_and_gradients(trained, name):
    """Each client's loss (the same on every model rank) and the gathered
    gradient of every leaf against the one-process port and ``jax.grad``
    of the reference's loss."""
    got, wants = trained
    job, blocks = got[name]
    (plosses, pgrads), (jlosses, jgrads) = wants[name]
    d = job["mesh"][0]
    losses = np.concatenate([blocks[r * job["mesh"][1]]["losses"]
                             for r in range(d)])
    for r, b in enumerate(blocks):   # every model rank the same loss
        np.testing.assert_array_equal(
            b["losses"], blocks[r - r % job["mesh"][1]]["losses"])
    _close(losses, plosses, f"{name}: losses vs the port", LOSS_RTOL, 0)
    _close(losses, jlosses, f"{name}: losses vs the reference", LOSS_RTOL,
           0)
    grads = _gathered(job, blocks, "grads")
    assert set(grads) == set(pgrads) == set(jgrads)
    for k, g in grads.items():
        _close(g.numpy(), pgrads[k], f"{name}: grad {k} vs the port")
        _close(g.numpy(), jgrads[k], f"{name}: grad {k} vs the reference")


def _history(metrics):
    rows = {n: torch.stack([torch.from_numpy(np.asarray(m[n]))
                            for m in metrics]) for n in metrics[0]}
    hist, ledger = rounds.history_and_ledger(rows)
    return hist, [b.header_hash for b in ledger.blocks], \
        ledger.validate_chain()


@pytest.mark.parametrize("name", [n for n in ROUND_CASES
                                  if n not in BITWISE])
def test_mesh_rounds_hold_to_the_one_process_port_and_reference(trained,
                                                                 name):
    got, wants = trained
    job, blocks = got[name]
    (pparams, phist, _, pvalid), ref = wants[name]
    for b in blocks:   # metrics replicated on every rank
        for m, m0 in zip(b["metrics"], blocks[0]["metrics"]):
            assert all(np.array_equal(m[n], m0[n]) for n in m0)
    params = _gathered(job, blocks, "params")
    hist, _, valid = _history(blocks[0]["metrics"])
    assert valid and pvalid and len(hist) == len(phist) == K
    for k, v in params.items():
        _close(v.numpy(), pparams[k], f"{name}: params {k} vs the port")
    for r, (h, w) in enumerate(zip(hist, phist)):
        for key in ("local_loss_mean", "global_loss", "divergence"):
            _close(h[key], w[key], f"{name}: round {r} {key} vs the port")
    if ref is not None:
        jparams, jhist, jvalid = ref
        assert jvalid
        for k, v in params.items():
            _close(v.numpy(), jparams[k], f"{name}: params {k} vs the "
                                          "reference")
        for r, (h, w) in enumerate(zip(hist, jhist)):
            for key in ("local_loss_mean", "global_loss", "divergence"):
                _close(h[key], w[key], f"{name}: round {r} {key} vs the "
                                       "reference")


@pytest.mark.parametrize("name", ["phi4 (2, 2)", "phi4 psum (2, 2)"])
def test_replicated_leaves_stay_bitwise_across_the_model_ranks(trained,
                                                               name):
    """After K rounds the leaves no model rank splits (the norm scales)
    hold the same bits on both model ranks of each data coordinate, and
    the split ones differ (each rank its own block)."""
    got, _ = trained
    job, blocks = got[name]
    whole = [k for k, s in blocks[0]["specs"].items()
             if not any(e and "model" in e for e in s[1:])]
    assert whole and all("norm" in k for k in whole)
    for d in range(job["mesh"][0]):
        a, b = blocks[2 * d]["params"], blocks[2 * d + 1]["params"]
        for k in a:
            assert np.array_equal(a[k], b[k]) == (k in whole), k


def test_mesh_rounds_receive_their_analytic_bytes(trained):
    """phi4 smoke at (2, 2), C = 4, one lazy client: the data axis
    all-gathers the other rank's 2 clients' model blocks once a round
    for the perturb stage (the round's gathered set), and the other
    rank's 2 local losses (fp32), best hashes and nonces (int64 words) and
    eval losses; the model axis all-reduces, per client
    and gradient evaluation, 5 activations forward and 5 backward (the
    embedding, 2 x (attention, MLP), and the 5 column blocks' inputs)
    plus the vocab-parallel loss's two [M, S - 1] terms, and gathers its
    [M, S - 1] maxima and each leaf's digest partials."""
    got, _ = trained
    job, blocks = got["phi4 (2, 2)"]
    cfg = job["cfg"]
    block_floats = sum(v[0].size for v in blocks[0]["params"].values())
    n_split = sum(any(e and "model" in e for e in s[1:])
                  for s in blocks[0]["specs"].values())
    act = M * (SEQ - 1) * cfg.d_model * 4
    evals = K * ROUND["tau"] * 2 + K * 2    # local steps + eval, 2 clients
    bwd = K * ROUND["tau"] * 2
    terms = M * (SEQ - 1) * 4
    want = {
        "all_gather over data": K * (2 * block_floats * 4 + 2 * 4
                                     + 2 * (8 + 8) + 2 * 4),
        "all_reduce over model": evals * (5 * act + 2 * terms)
        + bwd * 5 * act,
        "all_gather over model": evals * terms + K * n_split * (1 + 4) * 4}
    for b in blocks:
        assert b["received"] == want


@pytest.mark.parametrize("name", BITWISE)
def test_model_extent_one_is_bitwise_the_one_process_engine(trained, name):
    got, wants = trained
    job, blocks = got[name]
    (pparams, phist, phashes, pvalid), _ = wants[name]
    params = _gathered(job, blocks, "params")
    hist, hashes, valid = _history(blocks[0]["metrics"])
    assert valid and pvalid
    assert all(np.array_equal(v.numpy(), pparams[k])
               for k, v in params.items())
    assert hist == phist and hashes == phashes


def test_communicate_on_model_blocks(trained):
    """The same [C, ...] params cut into (data, model) blocks: the digest
    is bitwise the fold of each leaf's blocks' sums added in block order,
    the divergence within rtol 1e-6 of one process's sweep, and every
    rank's fedavg block bitwise the one-process mix's, and so is its
    block of the ring's halo mix."""
    got, _ = trained
    job, blocks = got["stage"]
    full = {k: torch.from_numpy(v) for k, v in job["params"].items()}
    pspecs = blocks[0]["specs"]
    acc = mining.as_word(mining.DIGEST_INIT)
    for k in sorted(full):
        parts = []
        for m in range(2):
            one = specs.MeshShape(("data", "model"), (2, 2), rank=m)
            blk = specs.shard_leaf(full[k], (None,) + pspecs[k][1:], one)
            s, res = digest_div_flat_ref(
                blk.reshape(STAGE_CLIENTS, -1).contiguous())
            parts.append(torch.cat([s.reshape(1), res]))
            if not any(e and "model" in e for e in pspecs[k][1:]):
                break
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        acc = mining.fold_digest(acc, total[0])
    _, want_div = fedavg_ops.digest_divergence_tree(full)
    mixed = _gathered(job, blocks, "params")
    want_mix = fedavg_ops.fedavg_tree(full)
    for b in blocks:
        assert b["digest"] == int(acc)
        np.testing.assert_allclose(b["divergence"], float(want_div),
                                   rtol=1e-6)
    assert all(torch.equal(v, want_mix[k]) for k, v in mixed.items())
    assert topology.resolve_mix_plan(RING, (("data", 2),)).mode \
        == topology.EXEC_HALO
    ring = specs.gather_tree(
        [{k: torch.from_numpy(v) for k, v in b["more_params"][0].items()}
         for b in blocks], pspecs, specs.MeshShape(("data", "model"),
                                                   job["mesh"]))
    want_ring = rounds.make_communicate(RING, "cpu")(full, full, 0)[0]
    assert all(torch.equal(v, want_ring[k]) for k, v in ring.items())
