"""The port's training modules against the JAX package's, on the CPU (part
2; ``tests/test_torch_train_loss.py`` has the first five smoke archs):
``train_loss`` and its gradients for the other five smoke archs (the MoE
archs with their load-balance ``aux``), the optimizers and schedules
(``training/optim.py``), the centralized step with and without
microbatches (``training/train_state.py``), checkpoints written by one
package and restored by the other (``training/checkpoint.py``), the
round engine's microbatched gradient (``rounds._microbatched_grad``), and
the synthetic token streams (``data/synthetic.py``, ``LMDataSource``).

Tolerance: rtol / atol 1e-5 on losses, gradients, optimizer updates and
schedules (the same fp32 ops in another order); checkpoints and ledgers
round-trip exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import chain as jchain
from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.training import checkpoint as jcheckpoint
from repro.training import optim as joptim
from repro.training import train_state as jtrain_state
from repro_torch import configs, tree
from repro_torch.core import chain, rounds
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.training import checkpoint, optim, train_state
from repro_torch.weights import lm_params_from_jax

from torch_runs import LM_TOL, assert_loss_and_grads_match, \
    lm_batch_to_torch
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ARCHS = ["hubert-xlarge", "phi4-mini-3.8b", "kimi-k2-1t-a32b", "minicpm-2b",
         "deepseek-v2-236b"]
MOE = {"kimi-k2-1t-a32b", "deepseek-v2-236b"}
# the cheapest smoke arch to compile on the reference's side
STEP_ARCH = "nemotron-4-15b"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    aux = assert_loss_and_grads_match(arch)
    assert (aux > 0) == (arch in MOE)


def _close(got, want, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _trees(seed):
    """(params, grads) as numpy trees of a dict-and-list layout."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"a": leaf(3, 4), "b": [leaf(5), {"c": leaf(2, 2)}]}
    grads = {"a": leaf(3, 4), "b": [leaf(5), {"c": leaf(2, 2)}]}
    return params, grads


def _as(tree_np, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return tree.tree_map(lambda x: conv(np.array(x)), tree_np)


def _assert_trees_close(got, want, tol=LM_TOL):
    gflat = tree.flatten(tree.tree_map(lambda x: x.numpy(), got))
    wflat = tree.flatten(jax.tree.map(np.asarray, want))
    assert set(gflat) == set(wflat)
    for k in wflat:
        _close(gflat[k], wflat[k], tol)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw",
                                  "adamw_decay", "recipe_minicpm",
                                  "recipe_qwen"])
def test_optimizers_match_reference(name):
    """Three updates of each optimizer on the same params and gradients,
    from the same state, at steps 0, 1, 2."""
    make = {"sgd": lambda m: m.sgd(0.1),
            "sgd_momentum": lambda m: m.sgd(lambda s: 0.05 + 0.0 * s, 0.9),
            "adamw": lambda m: m.adamw(1e-2),
            "adamw_decay": lambda m: m.adamw(1e-2, weight_decay=0.1),
            "recipe_minicpm": lambda m: m.recipe_for("minicpm-2b", 1e-2, 20),
            "recipe_qwen": lambda m: m.recipe_for("qwen3-32b", 1e-2, 20)}
    params_np, grads_np = _trees(0)
    jopt, opt = make[name](joptim), make[name](optim)
    jp, p = _as(params_np, "jax"), _as(params_np, "torch")
    js, s = jopt.init(jp), opt.init(p)
    for step in range(3):
        g_np = tree.tree_map(lambda x: x * (step + 1), grads_np)
        jp, js = jopt.update(_as(g_np, "jax"), js, jp, jnp.int32(step))
        p, s = opt.update(_as(g_np, "torch"), s, p,
                          torch.tensor(step, dtype=torch.int32))
        _assert_trees_close(p, jp)
        _assert_trees_close(s, js)


@pytest.mark.parametrize("name", ["wsd", "cosine"])
def test_schedules_match_reference(name):
    args = {"wsd": (3e-4, 10, 70, 20), "cosine": (3e-4, 10, 100)}[name]
    jlr = getattr(joptim, f"{name}_schedule")(*args)
    lr = getattr(optim, f"{name}_schedule")(*args)
    for step in [0, 1, 5, 9, 10, 11, 50, 79, 80, 81, 90, 99, 100, 150]:
        _close(float(lr(step)), float(jlr(jnp.int32(step))))
        _close(float(lr(torch.tensor(step))), float(jlr(step)))


def _step_inputs():
    jcfg, cfg = (jconfigs.get_smoke_arch(STEP_ARCH),
                 configs.get_smoke_arch(STEP_ARCH))
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    jbatch = jregistry.make_train_batch(
        jax.random.key(1), jcfg, jconfigs.ShapeConfig("t", 12, 4, "train"))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, jbatch, params, lm_batch_to_torch(jbatch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """Two steps of the centralized step under SGD with momentum: params,
    loss, grad norm and the metrics. (AdamW divides each gradient by its
    own root mean square, so where a gradient is near 0 its last bits
    decide the update: ``test_optimizers_match_reference`` holds it on
    gradients of unit scale.)"""
    jcfg, cfg, jparams, jbatch, params, batch = _step_inputs()
    jopt, opt = joptim.sgd(0.1, 0.9), optim.sgd(0.1, 0.9)
    jstep = jax.jit(jtrain_state.make_train_step(
        lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False), jopt,
        microbatches))
    step = train_state.make_train_step(
        lambda p, b: registry.loss_fn(p, cfg, b), opt, microbatches)
    jstate = jtrain_state.create(jparams, jopt)
    state = train_state.create(params, opt)
    for _ in range(2):
        jstate, jout = jstep(jstate, jbatch)
        state, out = step(state, batch)
        assert set(out) == set(jout)
        for k in jout:
            _close(float(out[k]), float(jout[k]))
    assert int(state.step) == int(jstate.step) == 2
    _assert_trees_close(state.params, jstate.params)


def _ledgers():
    digests = [0x1234, 0xBEEF, 0x77]
    args = (digests, [1, 0, 2], [11, 12, 13], [0x0FFF, 0x0ABC, 0x0001])
    return (jchain.ledger_from_scan(*args, ledger=jchain.Ledger(4)),
            chain.ledger_from_scan(*args, ledger=chain.Ledger(4)))


def test_checkpoints_restore_across_the_two_packages(tmp_path):
    """A checkpoint of an LM's params and the ledger written by the
    reference restores in the port, and one written by the port restores
    in the reference: every leaf equal, the step, the ledger's blocks and
    difficulty; a shape mismatch raises."""
    jcfg, cfg, jparams, _, params, _ = _step_inputs()
    jledger, ledger = _ledgers()
    jcheckpoint.save(str(tmp_path / "jax"), jparams, step=3, ledger=jledger)
    got, step, got_ledger = checkpoint.restore(str(tmp_path / "jax"), params)
    assert step == 3 and got_ledger.validate_chain()
    assert [vars(b) for b in got_ledger.blocks] == \
        [vars(b) for b in jledger.blocks]
    assert got_ledger.difficulty_bits == 4
    want = tree.flatten(jax.tree.map(np.asarray, jparams))
    for k, v in tree.flatten(got).items():
        np.testing.assert_array_equal(v.numpy(), want[k])

    path = checkpoint.save(str(tmp_path / "torch"), params, step=7,
                           ledger=ledger)
    assert path.endswith("ckpt_00000007.npz")
    jgot, jstep, jgot_ledger = jcheckpoint.restore(str(tmp_path / "torch"),
                                                   jparams)
    assert jstep == 7 and jgot_ledger.validate_chain()
    assert jgot_ledger.head_hash == ledger.head_hash
    for k, v in tree.flatten(jax.tree.map(np.asarray, jgot)).items():
        np.testing.assert_array_equal(v, want[k])
    # the port's own round trip, into the template's structure
    again, _, _ = checkpoint.restore(str(tmp_path / "torch"), params, step=7)
    assert tree.flatten(again).keys() == tree.flatten(params).keys()
    bad = dict(params, embed=torch.zeros(3))
    with pytest.raises(ValueError, match="embed"):
        checkpoint.restore(str(tmp_path / "torch"), bad)


def test_microbatched_grad_matches_reference():
    """The round engine's gradient over 2 microbatches of each client's
    batch against the reference's ``_microbatched_grad`` vmapped over the
    clients, as its ``make_local_train`` runs it; and against the
    one-batch gradient of the port."""
    jcfg, cfg = (jconfigs.get_smoke_arch(STEP_ARCH),
                 configs.get_smoke_arch(STEP_ARCH))
    c = 2
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    jstacked = jax.tree.map(lambda x: jnp.stack([x, x * 0.9]), jparams)
    jbatch = jregistry.make_train_batch(
        jax.random.key(1), jcfg, jconfigs.ShapeConfig("t", 12, 4, "train"))
    jbatch = jax.tree.map(lambda x: x.reshape((c, 2) + x.shape[1:]), jbatch)
    grad_fn = jrounds._microbatched_grad(
        lambda p, b: jregistry.loss_fn(p, jcfg, b, remat=False), 2)
    jloss, jgrads = jax.jit(jax.vmap(grad_fn))(jstacked, jbatch)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in tree.flatten(jax.tree.map(np.asarray,
                                                    jstacked)).items()}
    batch = lm_batch_to_torch(jbatch)
    loss, grads = rounds._microbatched_grad(registry.client_losses(cfg),
                                            2)(params, batch)
    _close(loss.numpy(), jloss)
    jflat = tree.flatten(jax.tree.map(np.asarray, jgrads))
    for k, g in zip(sorted(params), grads):
        _close(g.numpy(), jflat[k])
    with pytest.raises(ValueError, match="microbatches"):
        rounds._microbatched_grad(registry.client_losses(cfg), 3)(params,
                                                                   batch)


def test_lm_token_stream_is_zipf_with_the_bigram_repeat():
    gen = torch.Generator().manual_seed(0)
    toks = synthetic.lm_token_stream(gen, 64, 128, 512)
    assert toks.shape == (64, 128) and toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < 512
    counts = torch.bincount(toks.reshape(-1), minlength=512)
    assert int(counts.argmax()) in (0, 1)
    repeat = (toks[:, 1:] == (toks[:, :-1] + 1) % 512).float().mean()
    # p 0.3 of a repeat of the left neighbour's own draw, which the left
    # neighbour kept with p 0.7 (the Zipf draws add a few more)
    assert 0.21 < float(repeat) < 0.3
    again = synthetic.lm_token_stream(torch.Generator().manual_seed(0),
                                      64, 128, 512)
    assert torch.equal(toks, again)


@pytest.mark.parametrize("arch", ["xlstm-125m", "paligemma-3b",
                                  "hubert-xlarge"])
def test_lm_data_source_lays_out_the_references_batches(arch):
    """Both packages' ``round_batch`` and ``stacked_batches`` give the
    same leaves and shapes; round k of the stack is ``round_batch(k)``,
    and a seed gives the same draws again."""
    cfg, jcfg = configs.get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    shape = configs.ShapeConfig("t", 24, 6, "train")
    src = pipeline.LMDataSource(cfg, shape, 3, seed=1, device="cpu")
    jsrc = jpipeline.LMDataSource(jcfg, shape, 3, seed=1)
    got, want = src.stacked_batches(2), jsrc.stacked_batches(2)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert (got[k].dtype == torch.bool) == (v.dtype == jnp.bool_), k
    one = src.round_batch(1)
    for k, v in one.items():
        assert torch.equal(got[k][1], v)
        assert torch.equal(v, pipeline.LMDataSource(
            cfg, shape, 3, seed=1, device="cpu").round_batch(1)[k])
    with pytest.raises(ValueError, match="divide"):
        pipeline.LMDataSource(cfg, shape, 4, device="cpu")
