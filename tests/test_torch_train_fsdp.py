"""The BLADE-FL train step on a (data, model) mesh under the L2 layout
(``launch/steps.py::build_train_step`` with no client axes), over gloo
ranks on the CPU, against the one-process port and the JAX package.

Under L2 every rank holds all C clients; each client's params are split
FSDP-style over ``data`` (and over ``model`` where the reference splits a
leaf there), each client's rows over ``data``, and each rank runs its
block of every one of the reference's microbatches. Two worlds: 4 ranks
as (data 2, model 2) and 2 ranks as (2, 1), each spawned once.

- The loss and the gradients of a local iteration over 2 microbatches
  (``step.grad_fn``) for qwen3 smoke at (2, 1) and (2, 2) (the qk-norm
  scales enter the batch), jamba smoke at (2, 1) (Mamba and MoE under
  FSDP) and deepseek-v2 smoke at (2, 1) (MLA and MoE), held to the
  one-process port and to ``jax.grad`` of the reference's loss through
  its ``_microbatched_grad`` on the same params: losses at rtol 1e-5,
  gradients at rtol 1e-4 / atol 1e-5.
- The MoE witness: jamba's client 0 repeats one token over the first
  half of its rows, so that its microbatches' routing depends on which
  rows share a call. The losses of the two faults the layout guards
  against (the microbatches cut from each rank's contiguous block, and
  each rank's own load-balance loss) are far off the held ones.
- K = 2 rounds of qwen3 smoke at (2, 2), one lazy client fed the
  reference's noise, and of jamba smoke at (2, 1), C = 2, against the
  one-process port and the reference's ``run_blade_fl``: params,
  per-round losses and divergence at rtol 1e-4 / atol 1e-5, both ledgers
  valid, the replicated leaves bitwise across the ranks
  (``specs.gather_tree``).
- The bytes a rank receives, by op and axes, equal to the analytic
  count at (2, 2), the FSDP reduce-scatter's ring included; the
  reduce-scatter itself against the sum of the ranks' tensors.
- jamba, deepseek-v2, kimi-k2, xlstm-125m, paligemma-3b and
  hubert-xlarge smoke at (2, 2) build (every family's forward splits
  over model); qwen3-32b's one-H100 cut keeps every published width.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist
from repro import configs as jconfigs
from repro.core import rounds as jrounds
from repro.models import registry as jregistry
from repro_torch import tree
from repro_torch.configs import ShapeConfig, get_one_h100_arch, \
    get_smoke_arch
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3
from repro_torch.core import rounds
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.sharding import specs
from repro_torch.sharding.specs import ShardingPlan
from repro_torch.weights import lm_params_from_jax
from test_torch_train_mesh import reference_lazy_noise

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
C, M, SEQ, K = 2, 4, 16, 2    # clients, samples a client, tokens, rounds
N_MB = 2                      # microbatches of M / 2 = 2 samples
L2 = ShardingPlan(C, (), ("data",), fsdp_axes=("data",))
GRAD_SPEC = rounds.RoundSpec(n_clients=C, tau=1, eta=1e-2,
                             microbatches=N_MB)
ROUND = dict(n_clients=C, tau=1, eta=1e-2, mine_attempts=256,
             difficulty_bits=2, microbatches=N_MB, eval_global_loss=False)
QWEN, JAMBA = "qwen3-32b", "jamba-1.5-large-398b"
DEEPSEEK, KIMI = "deepseek-v2-236b", "kimi-k2-1t-a32b"
# name -> (arch, mesh)
GRAD_CASES = {"qwen3 (2, 1)": (QWEN, (2, 1)), "qwen3 (2, 2)": (QWEN, (2, 2)),
              "jamba (2, 1)": (JAMBA, (2, 1)),
              "deepseek (2, 1)": (DEEPSEEK, (2, 1))}
WITNESS = "jamba (2, 1)"
# name -> (arch, mesh, lazy clients fed the reference's noise)
ROUND_CASES = {"qwen3 (2, 2)": (QWEN, (2, 2), 1),
               "jamba (2, 1)": (JAMBA, (2, 1), 0)}
STEP_SEED = 3


def _seed(name):
    return sum(map(ord, name))


def _jparams(jcfg, seed):
    return jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(seed), jcfg))


def _flat_port(jparams):
    return {k: v.numpy() for k, v in
            tree.flatten(lm_params_from_jax(jparams, "cpu")).items()}


def _tokens(name, vocab, lead):
    """Tokens from the case's seed; on the witness, client 0's first row
    of each microbatch (the data rank 0's) one token throughout."""
    tokens = np.random.default_rng(_seed(name)).integers(
        0, vocab, lead + (M, SEQ)).astype(np.int32)
    if name == WITNESS:
        tokens[0, ::M // N_MB] = tokens[0, 0, 0]
    return tokens


def _jloss(jcfg):
    return lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False)


def _grad_want(arch, name):
    """The one-process port's and the reference's per-client losses and
    gradients ([C, ...] a leaf) over N_MB microbatches."""
    cfg, jcfg = get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    jparams = _jparams(jcfg, _seed(arch))
    tokens = _tokens(name if name == WITNESS else arch, cfg.vocab, (C,))
    flat = _flat_port(jparams)
    full = {k: torch.from_numpy(np.repeat(v[None], C, axis=0))
            .requires_grad_(True) for k, v in flat.items()}
    losses, grads = rounds.make_grad(registry.client_losses(cfg), GRAD_SPEC)(
        full, {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    port = (losses.numpy(),
            {k: g.numpy() for k, g in zip(sorted(full), grads)})
    grad_fn = jax.jit(jrounds._microbatched_grad(_jloss(jcfg), N_MB))
    jl, jg = [], []
    for i in range(C):
        loss, g = grad_fn(jparams, {"tokens": tokens[i]})
        jl.append(float(loss))
        jg.append(tree.flatten(jax.tree.map(np.asarray, g)))
    ref = (np.array(jl), {k: np.stack([g[k] for g in jg]) for k in jg[0]})
    job = {"kind": "grad", "cfg": cfg, "mesh": GRAD_CASES[name][1],
           "plan": L2, "spec": GRAD_SPEC, "params": flat, "tokens": tokens,
           "witness": name == WITNESS}
    return job, port, ref


def _round_want(name, monkeypatch):
    """The job of a rounds case, the one-process port's K rounds (the
    reference's lazy noise in place of its draws) and the reference's."""
    arch, mesh, n_lazy = ROUND_CASES[name]
    cfg, jcfg = get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    jparams = _jparams(jcfg, _seed(name))
    tokens = _tokens(name, cfg.vocab, (K, C))
    spec_kw = dict(ROUND, n_lazy=n_lazy, sigma2=1e-4 if n_lazy else 0.0)
    spec = rounds.RoundSpec(**spec_kw)
    flat = _flat_port(jparams)
    key = jax.random.fold_in(jax.random.key(0), 2)
    noise = (reference_lazy_noise(jparams, key, K, n_lazy, C) if n_lazy
             else None)
    if noise is not None:
        monkeypatch.setattr(rounds, "draw_noise", lambda *a, **kw: {
            "lazy": {k: torch.from_numpy(v) for k, v in noise.items()}})
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec,
        {k: torch.from_numpy(v) for k, v in flat.items()},
        {"tokens": torch.from_numpy(tokens.astype(np.int64))}, K,
        seed=STEP_SEED, device="cpu", stacked=True)
    monkeypatch.undo()
    port = ({k: v.numpy() for k, v in state.params.items()}, hist,
            ledger.validate_chain())
    jstate, jhist, jledger = jrounds.run_blade_fl(
        _jloss(jcfg), jrounds.RoundSpec(**spec_kw), jparams,
        {"tokens": tokens}, key, K, stacked=True)
    ref = (tree.flatten(jax.tree.map(np.asarray, jstate.params)), jhist,
           jledger.validate_chain())
    job = {"kind": "rounds", "cfg": cfg, "mesh": mesh, "plan": L2,
           "spec": spec, "params": flat, "tokens": tokens,
           "seed": STEP_SEED,
           "noise": None if noise is None else [
               {"lazy": {k: v[i] for k, v in noise.items()}}
               for i in range(K)]}
    return job, port, ref


@pytest.fixture(scope="module")
def trained():
    """Every case on its mesh (a world of 4 ranks, one of 2), with the
    one-process port's and the reference's results."""
    mp = pytest.MonkeyPatch()
    worlds = {4: {}, 2: {}}
    wants = {}
    by_arch = {}
    for name, (arch, mesh) in GRAD_CASES.items():
        if name == WITNESS or arch not in by_arch:
            job, port, ref = _grad_want(arch, name)
            if name != WITNESS:
                by_arch[arch] = job, port, ref
        else:   # the same inputs on another mesh
            job, port, ref = by_arch[arch]
        worlds[mesh[0] * mesh[1]][f"grad {name}"] = dict(job, mesh=mesh)
        wants[f"grad {name}"] = (port, ref)
    for name, (_, mesh, _) in ROUND_CASES.items():
        job, port, ref = _round_want(name, mp)
        worlds[mesh[0] * mesh[1]][f"rounds {name}"] = job
        wants[f"rounds {name}"] = (port, ref)
    worlds[4]["reduce_scatter"] = {"kind": "reduce_scatter",
                                   "mesh": (2, 2)}
    got = {}
    for n, jobs in worlds.items():
        ranks = mesh_lib.run_world(torch_dist.train_fsdp_rank, n,
                                   backend="gloo", device="cpu",
                                   args=(jobs,))
        for name, job in jobs.items():
            got[name] = (job, [r[name] for r in ranks])
    return got, wants


def _gathered(job, blocks, key):
    return specs.gather_tree(
        [{k: torch.from_numpy(v) for k, v in b[key].items()}
         for b in blocks], blocks[0]["specs"],
        specs.MeshShape(("data", "model"), job["mesh"]))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_l2_loss_and_gradients_over_microbatches(trained, name):
    """Each client's loss, the same on every rank, and the gathered
    gradient of every leaf against the one-process port and the
    reference's microbatched ``jax.grad``."""
    got, wants = trained
    job, blocks = got[f"grad {name}"]
    (plosses, pgrads), (jlosses, jgrads) = wants[f"grad {name}"]
    for b in blocks:
        np.testing.assert_array_equal(b["losses"], blocks[0]["losses"])
    losses = blocks[0]["losses"]
    _close(losses, plosses, f"{name}: losses vs the port", LOSS_RTOL, 0)
    _close(losses, jlosses, f"{name}: losses vs the reference", LOSS_RTOL,
           0)
    grads = _gathered(job, blocks, "grads")
    assert set(grads) == set(pgrads) == set(jgrads)
    for k, g in grads.items():
        _close(g.numpy(), pgrads[k], f"{name}: grad {k} vs the port")
        _close(g.numpy(), jgrads[k], f"{name}: grad {k} vs the reference")


def test_moe_witness_sees_the_cut_and_the_aux_loss(trained):
    """On the witness case the held losses match (above), while the
    losses of the contiguous-block microbatch cut and of each rank's own
    load-balance loss sit far outside their tolerance: a step that went
    back to either fails the loss check."""
    got, wants = trained
    _, blocks = got[f"grad {WITNESS}"]
    (plosses, _), _ = wants[f"grad {WITNESS}"]
    for fault in ("contiguous", "own_aux"):
        off = np.abs(blocks[0][fault] - plosses) / np.abs(plosses)
        assert off.max() > 10 * LOSS_RTOL, (fault, off)
    # each rank's own load-balance loss differs across the ranks
    assert not np.array_equal(blocks[0]["own_aux"], blocks[1]["own_aux"])


def _history(metrics):
    rows = {n: torch.stack([torch.from_numpy(np.asarray(m[n]))
                            for m in metrics]) for n in metrics[0]}
    return rounds.history_and_ledger(rows)


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_l2_rounds_hold_to_the_one_process_port_and_reference(trained,
                                                              name):
    """Params, per-round losses and divergence against both; both ledgers
    valid; the metrics the same on every rank; ``gather_tree`` holds the
    replicas of every block (the leaves no axis splits, the model blocks
    on both data ranks) bitwise equal."""
    got, wants = trained
    job, blocks = got[f"rounds {name}"]
    (pparams, phist, pvalid), (jparams, jhist, jvalid) = \
        wants[f"rounds {name}"]
    for b in blocks:
        for m, m0 in zip(b["metrics"], blocks[0]["metrics"]):
            assert all(np.array_equal(m[n], m0[n]) for n in m0)
    params = _gathered(job, blocks, "params")
    hist, ledger = _history(blocks[0]["metrics"])
    assert ledger.validate_chain() and pvalid and jvalid
    assert len(hist) == len(phist) == len(jhist) == K
    for k, v in params.items():
        _close(v.numpy(), pparams[k], f"{name}: params {k} vs the port")
        _close(v.numpy(), jparams[k], f"{name}: params {k} vs the "
                                      "reference")
    for r, (h, w, j) in enumerate(zip(hist, phist, jhist)):
        for key in ("local_loss_mean", "divergence"):
            _close(h[key], w[key], f"{name}: round {r} {key} vs the port")
            _close(h[key], j[key], f"{name}: round {r} {key} vs the "
                                   "reference")


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (its phase 11 holds the card
    to the same analytic count, ``l2_received``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_l2_rounds_receive_their_analytic_bytes(trained):
    """qwen3 smoke at (2, 2), C = 2, K = 2 rounds of tau 1 over 2
    microbatches (``chip_smoke.l2_received`` counts each op): a round
    re-cuts the tokens (all-gathered over data); each (local step,
    microbatch, client) gathers its FSDP blocks over data in the forward
    and again in the checkpoint's recompute, reduce-scatters their
    gradients (a ring: the other rank's half), all-reduces the other
    leaves' gradients and the loss's sum and count over data, and
    runs the model axis' tensor-parallel collectives in both passes; a
    round gathers each split leaf's digest partials over its own axes."""
    got, _ = trained
    job, blocks = got["rounds qwen3 (2, 2)"]
    want = _chip_smoke().l2_received(
        job["cfg"], job["spec"], blocks[0]["specs"],
        {k: v.shape[1:] for k, v in blocks[0]["params"].items()},
        dict(zip(("data", "model"), job["mesh"])), M, SEQ, n_rounds=K)
    assert want["reduce_scatter over data"] > 0
    for b in blocks:
        assert b["received"] == want


def test_reduce_scatter_is_the_rank_block_of_the_sum(trained):
    """``ClientMesh.reduce_scatter`` over data, over model and over (data,
    model), along dims 0 and 1: each rank's block (its index along the
    axes) of the sum of every rank's tensor, a ring that receives (n - 1)
    / n of the tensor."""
    got, _ = trained
    _, ranks = got["reduce_scatter"]
    world = {r: torch_dist.rank_tensor(r) for r in range(4)}
    for r, res in enumerate(ranks):
        for (axes, dim), (block, received) in res.items():
            peers = [q for q in range(4) if all(
                (q // 2 == r // 2) if a == "data" else (q % 2 == r % 2)
                for a in ("data", "model") if a not in axes)]
            whole = sum(world[q] for q in peers)
            n = len(peers)
            index = peers.index(r)
            size = whole.shape[dim] // n
            np.testing.assert_array_equal(
                block, whole.narrow(dim, index * size, size).numpy())
            assert received == (n - 1) * block.size * 4


@pytest.mark.parametrize("arch", [JAMBA, DEEPSEEK, KIMI, "xlstm-125m",
                                  "paligemma-3b", "hubert-xlarge"])
def test_l2_refuses_unported_model_splits(arch):
    """At (2, 2) every family builds under L2, each client's leaves over
    (data, model): the Mamba, MLA and MoE archs
    (``test_torch_train_families.py`` holds their steps to one process)
    and the xLSTM, VLM and audio archs
    (``test_torch_train_xlstm_frontends.py``)."""
    cfg = get_smoke_arch(arch)
    seq = SEQ + (cfg.vlm_prefix_len if cfg.family == "vlm" else 0)
    step, _, plan, _ = steps.build_train_step(
        cfg, ShapeConfig("t", seq, C * M, "train"),
        specs.MeshShape(("data", "model"), (2, 2)), False,
        torch.float32, plan=L2)
    pspecs = step.in_specs[0].params
    assert plan == L2 and all(sp[0] is None for sp in pspecs.values())
    assert any(("model",) in sp and ("data",) in sp
               for sp in pspecs.values())


def test_qwen3_one_h100_keeps_every_published_width():
    """qwen3-32b's one-H100 cut: 2 of 64 layers, every other field the
    published config's."""
    cut = get_one_h100_arch(QWEN)
    assert cut.n_layers == 2
    assert dataclasses.replace(cut, name=QWEN3.name,
                               n_layers=QWEN3.n_layers) == QWEN3
    assert abs(cut.param_count() - 2.531e9) < 1e6
