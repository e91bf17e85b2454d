"""The port's LM training loss against the JAX package's, on the CPU
(part 1; ``tests/test_torch_training.py`` has the other five smoke archs):
``transformer.train_loss`` and its gradient with respect to every leaf for
five smoke archs, from the reference's params and batch; the chunked
cross-entropy and its chunk rule; remat equal to no remat; the training
batches; and the CPU wrappers of the flash and scan kernels under
autograd.

Tolerance: rtol / atol 1e-5 on the loss, its metrics and the gradients;
atol 3e-5 / rtol 1e-4 on the gradients of the recurrent archs (xLSTM,
Jamba's Mamba), as ``tests/test_torch_xlstm.py`` holds their layers. Both
sides compute in fp32, summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs, tree
from repro_torch.models import registry, transformer
from repro_torch.weights import lm_params_from_jax

from torch_runs import LM_TOL, assert_loss_and_grads_match, \
    lm_batch_to_torch
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ARCHS = ["xlstm-125m", "qwen3-32b", "nemotron-4-15b",
         "jamba-1.5-large-398b", "paligemma-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    aux = assert_loss_and_grads_match(arch)
    # Jamba's MoE layer adds its load-balance loss; the others have none
    assert (aux > 0) == (arch == "jamba-1.5-large-398b")


def _head_inputs(vocab, b, s, d, seed):
    rng = np.random.default_rng(seed)
    params = {"embed": (rng.standard_normal((vocab, d)) * 0.1)
              .astype(np.float32)}
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32)
    return params, h, labels, mask


@pytest.mark.parametrize("chunk", [0, 4, 1])
def test_chunked_ce_loss_matches_reference(chunk):
    """At the rule's chunk (the whole sequence here), a chunk that divides
    S in three and one position a chunk; with and without a mask."""
    cfg = configs.get_smoke_arch("phi4-mini-3.8b")
    jcfg = jconfigs.get_smoke_arch("phi4-mini-3.8b")
    assert cfg.tie_embeddings and jcfg.tie_embeddings
    params, h, labels, mask = _head_inputs(cfg.vocab, 2, 12, cfg.d_model, 3)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for m in (None, mask):
        want = jtransformer.chunked_ce_loss(
            {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
            jnp.asarray(h), jnp.asarray(labels),
            None if m is None else jnp.asarray(m), chunk)
        got = transformer.chunked_ce_loss(
            tparams, cfg, torch.from_numpy(h),
            torch.from_numpy(labels.astype(np.int64)),
            None if m is None else torch.from_numpy(m), chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=LM_TOL,
                                   atol=LM_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        transformer.chunked_ce_loss(tparams, cfg, torch.from_numpy(h),
                                    torch.from_numpy(labels.astype(np.int64)),
                                    None, 5)


def _reference_chunk(b, s, vocab):
    """The reference's rule, as ``chunked_ce_loss`` writes it."""
    chunk = max(1, min(s, int(256e6 / max(b * vocab * 4, 1))))
    while s % chunk:
        chunk -= 1
    return chunk


@pytest.mark.parametrize("b,s,vocab,want", [
    (2, 12, 512, 12),            # the whole sequence fits the budget
    (4, 255, 256_000, 51),       # 62 positions, stepped down to 51
    (8, 4095, 152_064, 45),      # 52, stepped down to 45
    (2, 255, 50_304, 255),       # xLSTM-125M's training row
    (64, 97, 256_000, 1),        # a prime S past the budget: one position
])
def test_ce_chunk_follows_the_reference_rule(b, s, vocab, want):
    assert transformer.ce_chunk(b, s, vocab) == want \
        == _reference_chunk(b, s, vocab)
    assert transformer.ce_chunk(b, s, vocab, chunk=s) == s


def test_remat_changes_no_value_nor_gradient():
    """Recomputing each period in the backward pass gives the same loss
    and the same gradients, bit for bit (the same ops in the same order)."""
    cfg = configs.get_smoke_arch("deepseek-v2-236b")
    params = tree.flatten(registry.init_model(
        torch.Generator().manual_seed(0), cfg))
    batch = registry.make_train_batch(torch.Generator().manual_seed(1), cfg,
                                      configs.ShapeConfig("t", 16, 2, "train"))
    out = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = registry.loss_fn(tree.unflatten(leaves), cfg, batch,
                                         remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
        out.append((loss, metrics["aux"], grads))
    (l0, a0, g0), (l1, a1, g1) = out
    assert float(a0) > 0
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


@pytest.mark.parametrize("arch", ["xlstm-125m", "paligemma-3b",
                                  "hubert-xlarge"])
def test_make_train_batch_lays_out_the_references_inputs(arch):
    cfg, jcfg = configs.get_smoke_arch(arch), jconfigs.get_smoke_arch(arch)
    shape = configs.ShapeConfig("t", 20, 3, "train")
    got = registry.make_train_batch(torch.Generator().manual_seed(0), cfg,
                                    shape)
    want = jregistry.make_train_batch(jax.random.key(0), jcfg, shape)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert (got[k].dtype == torch.bool) == (v.dtype == jnp.bool_), k
        assert got[k].is_floating_point() == jnp.issubdtype(v.dtype,
                                                            jnp.floating)
    for k in ("tokens", "targets"):
        if k in got:
            assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab


def test_vlm_labels_pad_the_patches_and_mask_them_out():
    """``_embed_inputs`` with labels: a VLM's labels padded by 0 over the
    P patches, the mask 0 there and 1 on the text, as the reference's."""
    jcfg, cfg = (jconfigs.get_smoke_arch("paligemma-3b"),
                 configs.get_smoke_arch("paligemma-3b"))
    jparams = jtransformer.init_lm(jax.random.key(0), jcfg)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    batch = {"patches": rng.standard_normal((2, cfg.vlm_prefix_len,
                                             cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab, (2, 5)),
             "labels": rng.integers(0, cfg.vocab, (2, 5))}
    jx, jl, jm = jtransformer._embed_inputs(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    x, labels, mask = transformer._embed_inputs(params, cfg,
                                                lm_batch_to_torch(batch))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=LM_TOL,
                               atol=LM_TOL)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


def test_cpu_kernel_wrappers_still_follow_autograd():
    """On the CPU the wrappers run their plain versions, which autograd
    follows: a GQA arch trains there (on the card their autograd.Functions
    launch the backward kernels)."""
    cfg = configs.get_smoke_arch("phi4-mini-3.8b")
    params = tree.flatten(registry.init_model(
        torch.Generator().manual_seed(0), cfg))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = registry.make_train_batch(torch.Generator().manual_seed(1), cfg,
                                      configs.ShapeConfig("t", 8, 1, "train"))
    loss, _ = registry.loss_fn(tree.unflatten(leaves), cfg, batch)
    loss.backward()
    q = [k for k in leaves if k.endswith("mixer/w_q")]
    assert q and all(float(leaves[k].grad.abs().sum()) > 0 for k in q)
