"""The BLADE-FL train step on a (data, model) mesh for the Mamba, MLA and
MoE families (``launch/steps.py::build_train_step``, L1 and L2), over
gloo ranks on the CPU, against the one-process port and the JAX package.

jamba smoke (Mamba channels, GQA heads, MoE experts over model),
deepseek-v2 smoke (MLA heads, MoE experts and a shared expert) and
kimi-k2 smoke (GQA, MoE with a shared expert), the reference's three L2
archs. Two worlds: 4 ranks (meshes (2, 2) and (1, 4)) and 2 ranks
((1, 2)), each spawned once.

- L1 (the clients over data, each client's params over model): the
  tensor-parallel loss and its gradients at (1, 2), (2, 2) and (1, 4),
  against the one-process port and ``jax.grad`` of the reference's loss
  on the same params (the differentiable collectives: Mamba's ``[u | z]``
  gather, whose backward is the reduce-scatter, and its ``w_x`` partial
  sum entering the channel blocks; MLA's latents entering the head
  blocks; the MoE's dispatched tokens and gates entering the expert
  block): losses at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5.
- L2 (every client on every rank, FSDP and rows over data, experts and
  heads over model): the loss and gradients of a local iteration over 2
  microbatches (``step.grad_fn``) at (2, 2) for all three and at (1, 4)
  for jamba, against the one-process port and the reference's
  ``_microbatched_grad``, at the same tolerances.
- K = 2 rounds of deepseek under L2 and of kimi under L1 at (2, 2), C =
  2, against the one-process port and the reference's ``run_blade_fl``
  (params, per-round losses and divergence at rtol 1e-4 / atol 1e-5, both
  ledgers valid), and jamba under L2 at (2, 2) and under L1 at (1, 4)
  (``aggregation.ModelBlocks``' partials over model 4) against the
  one-process port; the
  L2 runs' bytes by op and axes exactly ``chip_smoke.l2_received``'s
  count (the count phase 12 holds the card to).
- xLSTM's train step builds under L1 and L2 at (2, 2), its leaves over
  model (``test_torch_train_xlstm_frontends.py`` holds it to one process).
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
from repro_torch.configs import ShapeConfig, get_smoke_arch
from repro_torch.configs.base import SSMConfig
from repro_torch.core import rounds
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.sharding import specs
from repro_torch.sharding.specs import ShardingPlan
from repro_torch.weights import lm_params_from_jax
from test_torch_train_mesh import _grad_want as l1_grad_want

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
C, SEQ, K = 2, 16, 2
M_L1, M_L2, N_MB = 2, 4, 2     # samples a client; L2's microbatches
L1 = ShardingPlan(C, ("data",), ())
L2 = ShardingPlan(C, (), ("data",), fsdp_axes=("data",))
GRAD_SPEC = rounds.RoundSpec(n_clients=C, tau=1, eta=1e-2,
                             microbatches=N_MB)
ROUND = dict(n_clients=C, tau=1, eta=1e-2, mine_attempts=256,
             difficulty_bits=2, eval_global_loss=False)
JAMBA, DEEPSEEK, KIMI = ("jamba-1.5-large-398b", "deepseek-v2-236b",
                         "kimi-k2-1t-a32b")
SHORT = {JAMBA: "jamba", DEEPSEEK: "deepseek", KIMI: "kimi"}
# name -> (arch, layout, mesh, config changes)
GRAD_CASES = {f"{SHORT[a]} L1 {m}": (a, "L1", m, {})
              for a in (JAMBA, DEEPSEEK, KIMI)
              for m in ((1, 2), (2, 2), (1, 4))}
GRAD_CASES.update({f"{SHORT[a]} L2 (2, 2)": (a, "L2", (2, 2), {})
                   for a in (JAMBA, DEEPSEEK, KIMI)})
GRAD_CASES["jamba L2 (1, 4)"] = (JAMBA, "L2", (1, 4), {})
# MLA's blocks cutting a head (its weights gathered, the gather's
# backward the reduce-scatter), and Mamba's d_in of 127 run whole beside
# split leaves (w_in's columns gathered, the gradient cut to the block)
GRAD_CASES["deepseek cut heads L1 (1, 2)"] = (
    DEEPSEEK, "L1", (1, 2), {"n_heads": 3, "n_kv_heads": 3})
GRAD_CASES["jamba whole channels L1 (1, 2)"] = (
    JAMBA, "L1", (1, 2), {"d_model": 127, "ssm": SSMConfig(
        d_state=8, d_conv=4, expand=1)})
# name -> (arch, layout, mesh, held to the reference too)
ROUND_CASES = {"deepseek L2 (2, 2)": (DEEPSEEK, "L2", (2, 2), True),
               "kimi L1 (2, 2)": (KIMI, "L1", (2, 2), True),
               "jamba L2 (2, 2)": (JAMBA, "L2", (2, 2), False),
               # the digest and divergence partials over model 4
               "jamba L1 (1, 4)": (JAMBA, "L1", (1, 4), False)}
STEP_SEED = 3


def _seed(name):
    return sum(map(ord, name))


def _cfgs(arch, over=None):
    """The port's and the reference's smoke configs of ``arch`` with
    ``over``'s changes."""
    over = over or {}
    jover = {k: (getattr(jconfigs, type(v).__name__)(
        **dataclasses.asdict(v)) if dataclasses.is_dataclass(v) else v)
        for k, v in over.items()}
    return (dataclasses.replace(get_smoke_arch(arch), **over),
            dataclasses.replace(jconfigs.get_smoke_arch(arch), **jover))


def _jparams(arch, jcfg=None):
    return jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(_seed(arch)), jcfg or jconfigs.get_smoke_arch(arch)))


def _flat_port(jparams):
    return {k: v.numpy() for k, v in
            tree.flatten(lm_params_from_jax(jparams, "cpu")).items()}


def _tokens(what, vocab, shape):
    return np.random.default_rng(_seed(what)).integers(
        0, vocab, shape).astype(np.int32)


def _jloss(jcfg):
    return lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False)


def _l2_grad_want(arch, jparams, tokens):
    """The one-process port's and the reference's per-client losses and
    gradients over N_MB microbatches."""
    cfg, jcfg = get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    full = {k: torch.from_numpy(np.repeat(v[None], C, axis=0))
            .requires_grad_(True) for k, v in _flat_port(jparams).items()}
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
    return port, (np.array(jl),
                  {k: np.stack([g[k] for g in jg]) for k in jg[0]})


def _round_want(name):
    """A rounds case's job, the one-process port's K rounds and (when
    asked) the reference's."""
    arch, layout, mesh, with_ref = ROUND_CASES[name]
    cfg, jcfg = get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    jparams = _jparams(arch)
    m = M_L2 if layout == "L2" else M_L1
    tokens = _tokens(name, cfg.vocab, (K, C, m, SEQ))
    spec_kw = dict(ROUND, microbatches=N_MB if layout == "L2" else 1)
    spec = rounds.RoundSpec(**spec_kw)
    flat = _flat_port(jparams)
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec,
        {k: torch.from_numpy(v) for k, v in flat.items()},
        {"tokens": torch.from_numpy(tokens.astype(np.int64))}, K,
        seed=STEP_SEED, device="cpu", stacked=True)
    port = ({k: v.numpy() for k, v in state.params.items()}, hist,
            ledger.validate_chain())
    ref = None
    if with_ref:
        jstate, jhist, jledger = jrounds.run_blade_fl(
            _jloss(jcfg), jrounds.RoundSpec(**spec_kw), jparams,
            {"tokens": tokens}, jax.random.fold_in(jax.random.key(0), 2), K,
            stacked=True)
        ref = (tree.flatten(jax.tree.map(np.asarray, jstate.params)), jhist,
               jledger.validate_chain())
    job = {"kind": "rounds", "cfg": cfg, "mesh": mesh,
           "plan": L2 if layout == "L2" else L1, "spec": spec,
           "params": flat, "tokens": tokens, "seed": STEP_SEED}
    return job, port, ref


@pytest.fixture(scope="module")
def trained():
    """Every case on its mesh (a world of 4 ranks, one of 2), with the
    one-process port's and the reference's results."""
    worlds = {("train_mesh_rank", 4): {}, ("train_mesh_rank", 2): {},
              ("train_fsdp_rank", 4): {}}
    wants, by_arch = {}, {}
    for name, (arch, layout, mesh, over) in GRAD_CASES.items():
        cfg, jcfg = _cfgs(arch, over)
        key = (arch, layout, str(sorted(over.items())))
        if key not in by_arch:
            jparams = _jparams(arch, jcfg)
            if layout == "L1":
                tokens = _tokens(arch, cfg.vocab, (C, M_L1, SEQ))
                want = l1_grad_want(cfg, jcfg, jparams, tokens)
            else:
                tokens = _tokens(arch, cfg.vocab, (C, M_L2, SEQ))
                want = _l2_grad_want(arch, jparams, tokens)
            by_arch[key] = (_flat_port(jparams), tokens, want)
        flat, tokens, want = by_arch[key]
        rank_fn = "train_mesh_rank" if layout == "L1" else "train_fsdp_rank"
        worlds[rank_fn, mesh[0] * mesh[1]][name] = {
            "kind": "grad", "cfg": cfg, "mesh": mesh,
            "plan": L1 if layout == "L1" else L2, "spec": GRAD_SPEC,
            "params": flat, "tokens": tokens}
        wants[name] = want
    for name, (_, layout, mesh, _) in ROUND_CASES.items():
        job, port, ref = _round_want(name)
        rank_fn = "train_mesh_rank" if layout == "L1" else "train_fsdp_rank"
        worlds[rank_fn, mesh[0] * mesh[1]][f"rounds {name}"] = job
        wants[f"rounds {name}"] = (port, ref)
    got = {}
    for (rank_fn, n), jobs in worlds.items():
        if not jobs:
            continue
        ranks = mesh_lib.run_world(getattr(torch_dist, rank_fn), n,
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
def test_family_loss_and_gradients_on_a_mesh(trained, name):
    """Each client's loss (the same on every model rank; under L2 on every
    rank) and the gathered gradient of every leaf against the one-process
    port and the reference."""
    got, wants = trained
    job, blocks = got[name]
    (plosses, pgrads), (jlosses, jgrads) = wants[name]
    d, mo = job["mesh"]
    if GRAD_CASES[name][1] == "L1":   # each data rank its clients
        losses = np.concatenate([blocks[r * mo]["losses"]
                                 for r in range(d)])
        for r, b in enumerate(blocks):
            np.testing.assert_array_equal(b["losses"],
                                          blocks[r - r % mo]["losses"])
    else:
        losses = blocks[0]["losses"]
        for b in blocks:
            np.testing.assert_array_equal(b["losses"], losses)
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
    return rounds.history_and_ledger(rows)


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_family_rounds_hold_to_the_one_process_port_and_reference(
        trained, name):
    """Params, per-round losses and divergence against the one-process
    port (and the reference where the case names it); both ledgers valid;
    the metrics the same on every rank."""
    got, wants = trained
    job, blocks = got[f"rounds {name}"]
    port, ref = wants[f"rounds {name}"]
    for b in blocks:
        for mt, m0 in zip(b["metrics"], blocks[0]["metrics"]):
            assert all(np.array_equal(mt[n], m0[n]) for n in m0)
    params = _gathered(job, blocks, "params")
    hist, ledger = _history(blocks[0]["metrics"])
    assert ledger.validate_chain()
    for what, want in (("the port", port), ("the reference", ref)):
        if want is None:
            continue
        wparams, whist, wvalid = want
        assert wvalid and len(whist) == len(hist) == K
        for k, v in params.items():
            _close(v.numpy(), wparams[k], f"{name}: params {k} vs {what}")
        for r, (h, w) in enumerate(zip(hist, whist)):
            for key in ("local_loss_mean", "divergence"):
                _close(h[key], w[key], f"{name}: round {r} {key} vs {what}")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["deepseek L2 (2, 2)", "jamba L2 (2, 2)"])
def test_family_l2_rounds_receive_their_analytic_bytes(trained, name):
    """Each rank's bytes by op and axes over the K rounds: the FSDP
    gathers and reduce-scatters, the MoE's gathered routing choices and
    summed router probabilities over data, and over model each family's
    partial sums, Mamba's ``[u | z]`` gather and its reduce-scatter, and
    the gradients entering the column blocks
    (``chip_smoke.l2_received``)."""
    got, _ = trained
    job, blocks = got[f"rounds {name}"]
    want = _chip_smoke().l2_received(
        job["cfg"], job["spec"], blocks[0]["specs"],
        {k: v.shape[1:] for k, v in blocks[0]["params"].items()},
        dict(zip(("data", "model"), job["mesh"])), M_L2, SEQ, n_rounds=K)
    assert want["all_reduce over model"] > 0
    for b in blocks:
        assert b["received"] == want


@pytest.mark.parametrize("plan", [L1, L2])
def test_xlstm_model_split_raises_naming_9b_3b(plan):
    """xLSTM's model split builds under both layouts: the mLSTM's and sLSTM's head blocks and
    ``w_down``'s rows over model, and under L2 ``w_up``'s rows over
    data."""
    step, _, got, _ = steps.build_train_step(
        get_smoke_arch("xlstm-125m"),
        ShapeConfig("t", SEQ, C * M_L2, "train"),
        specs.MeshShape(("data", "model"), (2, 2)), False,
        torch.float32, plan=plan)
    pspecs = step.in_specs[0].params
    assert got == plan
    for path in ("period/j0/mixer/w_q", "period/j1/mixer/w_z"):
        assert pspecs[path][-1] == ("model",), (path, pspecs[path])
    assert pspecs["period/j1/mixer/r_i"][2] == ("model",)
    assert pspecs["period/j0/mixer/w_up"][2] == (
        ("data",) if plan.fsdp_axes else None)
