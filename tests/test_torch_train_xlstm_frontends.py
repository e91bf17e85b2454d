"""The BLADE-FL train step under the L1 layout (``launch/steps.py::
build_train_step``) for xlstm-125m, paligemma-3b and hubert-xlarge, over
gloo ranks on the CPU, against the one-process port and the JAX package.

The reference's table trains all three under L1 (``sharding/plans.py``):
the clients over data, each client's params over model. Two worlds: 4
ranks (meshes (2, 2) and (1, 4)) and 2 ranks ((1, 2)), each spawned
once.

- The tensor-parallel loss and the round-0 gradient of every leaf: xlstm
  smoke at (1, 2), (2, 2) and (1, 4) (the head-cutting case: every rank
  runs both heads, the gathers' backward the reduce-scatter, the whole
  gate and recurrent leaves entering the split blocks), paligemma smoke
  (prefix-LM, the cut MQA head, the tied vocab-split head, the text's
  lookup beside the patches) and hubert smoke (bidirectional, the
  positional conv on each rank's channels, the frames blended with the
  mask embedding entering it, the masked-prediction loss) at (1, 2) and
  (2, 2), against the one-process port and ``jax.grad`` of the
  reference's loss on the same params (``weights.lm_params_from_jax``):
  losses at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-5. The xLSTM
  output norm's statistic summed over model without entering the
  channel blocks (``enter_model``) would leave each rank's gradient
  partial: the gradients of the layers below it would be off.
- xlstm smoke under L2 at (2, 2) (FSDP rows of ``w_up`` / ``w_q`` and
  columns of ``w_down`` over data beside the heads over model): the loss
  and gradients of a local iteration against the one-process port.
- K = 2 rounds of each at (2, 2), C = 2, against the one-process port and
  the reference's ``run_blade_fl`` (params, per-round losses and
  divergence at rtol 1e-4 / atol 1e-5, both ledgers valid, the metrics
  the same on every rank); each rank's bytes by op and axes exactly
  ``chip_smoke.l1_received``'s (the count phase 13d holds the card to).
"""
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
from repro_torch.configs import get_smoke_arch
from repro_torch.core import rounds
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry
from repro_torch.sharding import specs
from repro_torch.sharding.specs import ShardingPlan
from repro_torch.weights import lm_params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
C, K = 2, 2
M, SEQ = 2, 12            # samples a client, positions a sample
L1 = ShardingPlan(C, ("data",), ())
L2 = ShardingPlan(C, (), ("data",), fsdp_axes=("data",))
ROUND = dict(n_clients=C, tau=1, eta=1e-2, mine_attempts=256,
             difficulty_bits=2, eval_global_loss=False)
GRAD_SPEC = rounds.RoundSpec(**ROUND)
XLSTM, VLM, AUDIO = "xlstm-125m", "paligemma-3b", "hubert-xlarge"
SHORT = {XLSTM: "xlstm", VLM: "paligemma", AUDIO: "hubert"}
# name -> (arch, layout, mesh)
GRAD_CASES = {f"xlstm L1 {m}": (XLSTM, "L1", m)
              for m in ((1, 2), (2, 2), (1, 4))}
GRAD_CASES.update({f"{SHORT[a]} L1 {m}": (a, "L1", m)
                   for a in (VLM, AUDIO) for m in ((1, 2), (2, 2))})
GRAD_CASES["xlstm L2 (2, 2)"] = (XLSTM, "L2", (2, 2))
ROUND_CASES = {f"{SHORT[a]} L1 (2, 2)": a for a in (XLSTM, VLM, AUDIO)}
STEP_SEED = 3


def _seed(name):
    return sum(map(ord, name))


def _cfgs(arch):
    return get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)


def _jparams(arch):
    return jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(_seed(arch)), jconfigs.get_smoke_arch(arch)))


def _flat_port(jparams):
    return {k: v.numpy() for k, v in
            tree.flatten(lm_params_from_jax(jparams, "cpu")).items()}


def _batch(cfg, what, lead):
    """A train batch of ``lead + (M,)`` rows (``registry
    .make_train_batch``'s layout) from a numpy seed of ``what``: a VLM's
    patches and text, the audio encoder's frames, mask positions (half)
    and targets, else tokens."""
    rng = np.random.default_rng(_seed(what))
    rows = lead + (M,)
    if cfg.audio_frontend:
        return {"frames": rng.standard_normal(
                    rows + (SEQ, cfg.d_model)).astype(np.float32),
                "mask_positions": rng.random(rows + (SEQ,)) < 0.5,
                "targets": rng.integers(0, cfg.vocab, rows + (SEQ,))
                .astype(np.int32)}
    if cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        return {"patches": rng.standard_normal(
                    rows + (p, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, rows + (SEQ,))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, rows + (SEQ,))
            .astype(np.int32)}


def _jloss(jcfg):
    return lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False)


def _grad_want(arch, jparams, batch):
    """The one-process port's and the reference's per-client losses and
    gradients ([C, ...] a leaf) on the same params and batch."""
    cfg, jcfg = _cfgs(arch)
    full = {k: torch.from_numpy(np.repeat(v[None], C, axis=0))
            .requires_grad_(True) for k, v in _flat_port(jparams).items()}
    keys = sorted(full)
    losses = registry.client_losses(cfg)(full, torch_dist._tensors(batch))
    grads = torch.autograd.grad(losses.sum(), [full[k] for k in keys],
                                materialize_grads=True)
    port = (losses.detach().numpy(),
            {k: g.numpy() for k, g in zip(keys, grads)})
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: _jloss(jcfg)(p, b)[0]))
    jl, jg = [], []
    for i in range(C):
        loss, g = value_and_grad(jparams, {n: v[i] for n, v in batch.items()})
        jl.append(float(loss))
        jg.append(tree.flatten(jax.tree.map(np.asarray, g)))
    return port, (np.array(jl),
                  {k: np.stack([g[k] for g in jg]) for k in jg[0]})


def _round_want(name):
    """A rounds case's job, the one-process port's K rounds and the
    reference's."""
    arch = ROUND_CASES[name]
    cfg, jcfg = _cfgs(arch)
    jparams = _jparams(arch)
    batch = _batch(cfg, name, (K, C))
    spec = rounds.RoundSpec(**ROUND)
    flat = _flat_port(jparams)
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec,
        {k: torch.from_numpy(v) for k, v in flat.items()},
        torch_dist._tensors(batch), K, seed=STEP_SEED, device="cpu",
        stacked=True)
    port = ({k: v.numpy() for k, v in state.params.items()}, hist,
            ledger.validate_chain())
    jstate, jhist, jledger = jrounds.run_blade_fl(
        _jloss(jcfg), jrounds.RoundSpec(**ROUND), jparams, batch,
        jax.random.fold_in(jax.random.key(0), 2), K, stacked=True)
    ref = (tree.flatten(jax.tree.map(np.asarray, jstate.params)), jhist,
           jledger.validate_chain())
    job = {"kind": "rounds", "cfg": cfg, "mesh": (2, 2), "plan": L1,
           "spec": spec, "params": flat, "batch": batch, "seed": STEP_SEED}
    return job, port, ref


@pytest.fixture(scope="module")
def trained():
    """Every case on its mesh (a world of 4 ranks, one of 2), with the
    one-process port's and the reference's results."""
    worlds = {("train_mesh_rank", 4): {}, ("train_mesh_rank", 2): {},
              ("train_fsdp_rank", 4): {}}
    wants, by_arch = {}, {}
    for name, (arch, layout, mesh) in GRAD_CASES.items():
        cfg, _ = _cfgs(arch)
        if arch not in by_arch:
            jparams = _jparams(arch)
            batch = _batch(cfg, arch, (C,))
            by_arch[arch] = (_flat_port(jparams), batch,
                             _grad_want(arch, jparams, batch))
        flat, batch, want = by_arch[arch]
        rank_fn = "train_mesh_rank" if layout == "L1" else "train_fsdp_rank"
        job = {"kind": "grad", "cfg": cfg, "mesh": mesh, "spec": GRAD_SPEC,
               "plan": L1 if layout == "L1" else L2, "params": flat}
        job.update({"batch": batch} if layout == "L1"
                   else {"tokens": batch["tokens"]})
        worlds[rank_fn, mesh[0] * mesh[1]][name] = job
        wants[name] = want
    for name in ROUND_CASES:
        job, port, ref = _round_want(name)
        worlds["train_mesh_rank", 4][f"rounds {name}"] = job
        wants[f"rounds {name}"] = (port, ref)
    got = {}
    for (rank_fn, n), jobs in worlds.items():
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
def test_xlstm_and_front_end_gradients_on_a_mesh(trained, name):
    """Each client's loss (the same on every model rank; under L2 on every
    rank) and the gathered round-0 gradient of every leaf against the
    one-process port and the reference."""
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
def test_xlstm_and_front_end_rounds_hold_to_the_port_and_reference(
        trained, name):
    """Params, per-round losses and divergence against the one-process
    port and the reference; both ledgers valid; the metrics the same on
    every rank."""
    got, wants = trained
    job, blocks = got[f"rounds {name}"]
    port, ref = wants[f"rounds {name}"]
    for b in blocks:
        for mt, m0 in zip(b["metrics"], blocks[0]["metrics"]):
            assert all(np.array_equal(mt[n], m0[n]) for n in m0)
    params = _gathered(job, blocks, "params")
    hist, ledger = _history(blocks[0]["metrics"])
    assert ledger.validate_chain()
    for what, (wparams, whist, wvalid) in (("the port", port),
                                           ("the reference", ref)):
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


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_xlstm_and_front_end_rounds_receive_their_analytic_bytes(
        trained, name):
    """Each rank's bytes by op and axes over the K rounds, exactly
    ``chip_smoke.l1_received``'s count: over data the other rank's client
    blocks and metrics; over model each layer's gathers, partial sums and
    reduce-scatters (``xlstm_terms`` for the xLSTM blocks, the audio
    front-end's conv gathered and its blended frames' gradient summed),
    the vocab-parallel loss's terms and the digest partials."""
    got, _ = trained
    job, blocks = got[f"rounds {name}"]
    cfg = job["cfg"]
    want = _chip_smoke().l1_received(
        cfg, job["spec"], blocks[0]["specs"],
        {k: v.shape[1:] for k, v in blocks[0]["params"].items()},
        dict(zip(("data", "model"), job["mesh"])), M,
        torch_dist.train_seq(cfg, job["batch"], 1), n_rounds=K)
    assert want["all_reduce over model"] > 0
    for b in blocks:
        assert b["received"] == want
