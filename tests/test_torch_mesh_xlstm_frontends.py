"""The serve steps on a mesh for the xLSTM blocks and the VLM's and the
audio encoder's front-ends (``launch/steps.py``), over gloo ranks on the
CPU, against the one-process port and the JAX package.

xlstm-125m smoke (an mLSTM and an sLSTM block, 2 heads of 128) is served
at (data, model) = (1, 2), (2, 2) and (1, 4): a prefill with the batch
over data, then 4 teacher-forced decode steps, each rank on its heads and
channels of d_in (at model 4 a rank's 64 columns of ``w_q`` / ``w_z`` /
... cut a head: the projections' columns are gathered and every rank runs
both heads, its row block of ``w_down`` taking its channels). paligemma
smoke (16 image patches under the prefix-LM mask, MQA: its one kv head's
columns split over model cut it) is served at (1, 2) and (2, 2) with the
cache's positions over model (capacity 52: the steps at 24..27 cross the
block edge at 26); hubert smoke (bidirectional, encoder-only: a prefill
alone, half the frames replaced by the mask embedding, the positional
conv on each rank's channels) at (1, 2) and (2, 2). The long-context
plan (batch 1, positions over (data, model)) serves xlstm and paligemma
(capacity 52: blocks of 13). Every case's ranks' blocks of each
position's logits and of the final state are gathered
(``specs.gather_tree``) and held to the one-device ``transformer.prefill``
/ ``decode_step`` of both packages on the same weights (the reference's
init) and inputs, at rtol 1e-4 / atol 1e-5. Each decode-state leaf is
split on the dim the reference's ``decode_state_pspecs`` names (the
xLSTM states' heads, the conv windows' channels). The bytes a rank
receives equal ``chip_smoke.serve_received``'s count of them, which has no
term inside the sLSTM's time loop. The serve steps and the train step
(L1, and L2 where the plan is valid) build for the three archs at smoke
and published widths at (1, 2), (2, 2) and (1, 4), every leaf that the
reference's specs split over model split in ``step.in_specs``.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist
from conftest import make_fake_mesh
from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke_arch as jget_smoke_arch
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.sharding import specs as jspecs
from repro_torch import tree
from repro_torch.configs import ShapeConfig, get_one_h100_arch, \
    get_smoke_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.sharding import specs
from repro_torch.sharding.specs import ShardingPlan
from repro_torch.weights import lm_params_from_jax

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 1e-4, 1e-5
N_STEPS = 4

PREFILL = ShardingPlan(1, (), ("data",))
DECODE = ShardingPlan(1, (), ("data",), seq_axes=("model",))
LONG_PREFILL = ShardingPlan(1, (), ())
LONG = ShardingPlan(1, (), (), seq_axes=("data", "model"))

XLSTM, VLM, AUDIO = "xlstm-125m", "paligemma-3b", "hubert-xlarge"
# name -> (arch, mesh, batch, prompt, capacity, prefill plan, decode plan)
CASES = {f"xlstm {m}": (XLSTM, m, 4, 8, 20, PREFILL, DECODE)
         for m in ((1, 2), (2, 2), (1, 4))}
CASES.update({f"paligemma {m}": (VLM, m, 4, 24, 52, PREFILL, DECODE)
              for m in ((1, 2), (2, 2))})
CASES.update({f"hubert {m}": (AUDIO, m, 4, 16, 16, PREFILL, PREFILL)
              for m in ((1, 2), (2, 2))})
CASES.update({
    "xlstm long-context (2, 2)": (XLSTM, (2, 2), 1, 8, 20, LONG_PREFILL,
                                  LONG),
    "paligemma long-context (2, 2)": (VLM, (2, 2), 1, 24, 52, LONG_PREFILL,
                                      LONG)})


def _steps(arch):
    return N_STEPS if get_smoke_arch(arch).has_decode else 0


def _inputs(name):
    """The case's configs, the reference's params, the prefill batch and
    the decode tokens (numpy), drawn from a seed of (arch, batch): cases
    that differ only in mesh or plan serve the same weights and inputs."""
    arch, _, b, prompt, _, _, _ = CASES[name]
    cfg, jcfg = get_smoke_arch(arch), jget_smoke_arch(arch)
    seed = sum(map(ord, f"{arch} {b}"))
    params = jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    if cfg.audio_frontend:
        batch = {"frames": rng.standard_normal(
                     (b, prompt, cfg.d_model)).astype(np.float32),
                 "mask_positions": rng.random((b, prompt)) < 0.5}
    elif cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        batch = {"patches": rng.standard_normal(
                     (b, p, cfg.d_model)).astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab, (b, prompt - p))
                 .astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, prompt))
                 .astype(np.int32)}
    tokens = rng.integers(0, cfg.vocab, (b, _steps(arch))).astype(np.int32)
    return cfg, jcfg, params, batch, tokens


def _one_process(cfg, params, batch, tokens, max_len):
    """The one-process port: every position's logits and the final
    state."""
    prompt = sum(v.shape[1] for k, v in batch.items()
                 if k != "mask_positions")
    p = lm_params_from_jax(params, "cpu")
    logits, state = transformer.prefill(p, cfg, torch_dist._tensors(batch),
                                        max_len=max_len)
    out = [logits]
    t = torch.from_numpy(tokens.astype(np.int64))
    for i in range(tokens.shape[1]):
        logits, state = transformer.decode_step(p, cfg, state, t[:, i],
                                                prompt + i)
        out.append(logits)
    return [x.numpy() for x in out], tree.tree_map(lambda x: x.numpy(),
                                                   state)


def _reference(jcfg, params, batch, tokens, max_len):
    """The JAX package's prefill and decode steps."""
    prompt = sum(v.shape[1] for k, v in batch.items()
                 if k != "mask_positions")
    logits, state = jtransformer.prefill(params, jcfg, batch,
                                         max_len=max_len)
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1]):
        logits, state = jtransformer.decode_step(
            params, jcfg, state, tokens[:, i], prompt + i)
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def served():
    """Every case on its mesh (one world of 4 ranks, one of 2), gathered;
    with the one-process port's and the reference's results."""
    worlds = {4: {}, 2: {}}
    wants, runs = {}, {}
    for name, (arch, mesh, b, prompt, cap, plan, dplan) in CASES.items():
        cfg, jcfg, params, batch, tokens = _inputs(name)
        worlds[mesh[0] * mesh[1]][name] = {
            "cfg": cfg, "mesh": mesh, "params": params,
            "dtype": torch.float32, "batch": batch, "tokens": tokens,
            "n": tokens.shape[1], "plan": plan, "decode_plan": dplan,
            "max_len": cap}
        key = (arch, b, prompt, cap)
        if key not in runs:
            runs[key] = (_one_process(cfg, params, batch, tokens, cap),
                         _reference(jcfg, params, batch, tokens, cap))
        wants[name] = runs[key]
    got = {}
    for n, cases in worlds.items():
        ranks = mesh_lib.run_world(torch_dist.serve_mesh_rank, n,
                                   backend="gloo", device="cpu",
                                   args=(cases,))
        for name, case in cases.items():
            mesh = specs.MeshShape(("data", "model"), case["mesh"])
            first = ranks[0][name]
            logits = [specs.gather_tree(
                [{"x": torch.from_numpy(r[name]["logits"][i])}
                 for r in ranks], {"x": first["logits_spec"]}, mesh)["x"]
                for i in range(case["n"] + 1)]
            state = specs.gather_tree(
                [tree.tree_map(torch.from_numpy, r[name]["state"])
                 for r in ranks], first["state_specs"], mesh)
            got[name] = ([x.numpy() for x in logits],
                         tree.tree_map(lambda x: x.numpy(), state),
                         [r[name]["received"] for r in ranks],
                         first["state_specs"])
    return got, wants


def _held(got, want_logits, want_state, name):
    logits, state = got[:2]
    assert len(logits) == len(want_logits)
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: logits at {i}")
    flat_want = tree.flatten(want_state)
    assert set(tree.flatten(state)) == set(flat_want)
    for path, x in tree.flatten(state).items():
        np.testing.assert_allclose(x, flat_want[path], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: state {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_xlstm_and_front_ends_on_a_mesh_hold_to_the_one_process_port(
        served, name):
    got, wants = served
    (want_logits, want_state), _ = wants[name]
    _held(got[name], want_logits, want_state, name)


@pytest.mark.parametrize("name", list(CASES))
def test_xlstm_and_front_ends_on_a_mesh_hold_to_the_reference(served, name):
    got, wants = served
    _, (want_logits, want_state) = wants[name]
    _held(got[name], want_logits, want_state, name)


def _ref_state_specs(name):
    """The reference's ``decode_state_pspecs`` of the case's decode state
    on a fake mesh of its shape, as the port's spec tuples."""
    arch, mesh, b, _, cap, _, dplan = CASES[name]
    jcfg = jget_smoke_arch(arch)
    jmesh = make_fake_mesh(mesh, ("data", "model"))
    jplan = jspecs.ShardingPlan(**dataclasses.asdict(dplan))
    state = jax.eval_shape(lambda: jtransformer.init_decode_state(
        jcfg, b, cap))
    pspecs = jspecs.decode_state_pspecs(jcfg, jmesh, jplan, state)
    flat = jax.tree_util.tree_flatten_with_path(
        pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jspecs._path_str(p): tuple(
        None if e is None else (e,) if isinstance(e, str) else tuple(e)
        for e in s) for p, s in flat[0]}


@pytest.mark.parametrize("name,leaf,dim", [
    ("xlstm (2, 2)", "period/j0/C", 2), ("xlstm (2, 2)", "period/j0/n", 2),
    ("xlstm (2, 2)", "period/j0/m", 2),
    ("xlstm (2, 2)", "period/j0/conv", 3),
    ("xlstm (2, 2)", "period/j1/c", 2), ("xlstm (2, 2)", "period/j1/h", 2),
    ("xlstm (2, 2)", "period/j1/m", 2),
    ("xlstm (2, 2)", "period/j1/conv", 3),
    # at model 4 the 2 heads stay whole, the 256 channels split
    ("xlstm (1, 4)", "period/j0/C", None),
    ("xlstm (1, 4)", "period/j1/conv", 3),
    ("paligemma long-context (2, 2)", "period/j0/k", 2)])
def test_decode_state_is_split_where_the_reference_splits_it(served, name,
                                                              leaf, dim):
    """Each decode-state leaf's spec is the reference's
    ``decode_state_pspecs``; the xLSTM states on their heads over model,
    the conv windows on their channels, the kv cache's positions over the
    long-context plan's (data, model)."""
    got, _ = served
    specs_got = tree.flatten(got[name][3], tuples=False)
    want = _ref_state_specs(name)
    assert set(specs_got) == set(want)
    for path, spec in specs_got.items():
        assert spec == want[path], (path, spec, want[path])
    spec = specs_got[leaf]
    if dim is None:
        assert not any(spec[2:]), (leaf, spec)
    else:
        split = CASES[name][6].seq_axes if leaf.endswith("/k") \
            else ("model",)
        assert spec[dim] == split, (leaf, spec)


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (its phase 13 holds the card
    to the same analytic count, ``serve_received``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(CASES))
def test_xlstm_and_front_ends_receive_their_analytic_bytes(served, name):
    """Each rank's bytes received by op, in the prefill and over the
    decode steps, exactly ``chip_smoke.serve_received``'s count (its
    docstring: the mLSTM's ``[u | z]`` gather, u gathered once a layer,
    the gathered projections where a head is cut, the norm's statistic
    and the row block's partial summed; the VLM's lookup over its text,
    its cut kv head gathered; the audio encoder's positional conv
    gathered and its kv heads gathered for the cache). A collective a
    step of the sLSTM's time loop would add 8 x the prefill's count
    there."""
    got, _ = served
    arch, mesh, b, prompt, cap, plan, dplan = CASES[name]
    want = _chip_smoke().serve_received(get_smoke_arch(arch), mesh, b,
                                        prompt, cap, plan, dplan,
                                        _steps(arch))
    for r, received in enumerate(got[name][2]):
        assert received == want, (r, received, want)


def _split_by_reference(cfg, jcfg, mesh_shape, plan, kind):
    """{path: [dims]} of every param leaf that the reference's
    ``param_pspecs`` splits over ``model`` (the client dim of a train
    step's leaves excluded), on a fake mesh of ``mesh_shape``."""
    jmesh = make_fake_mesh(mesh_shape, ("data", "model"))
    jplan = jspecs.ShardingPlan(**dataclasses.asdict(plan))
    n = plan.n_clients if kind in ("L1", "L2") else 1
    abstract = jax.eval_shape(lambda: jregistry.init_model(
        jax.random.key(0), jcfg))
    if n > 1:
        abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            (n,) + a.shape, a.dtype), abstract)
    pspecs = jspecs.param_pspecs(jcfg, jmesh, jplan, abstract)
    flat = jax.tree_util.tree_flatten_with_path(
        pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for p, s in flat[0]:
        dims = [d for d, e in enumerate(s)
                if e is not None and "model" in ((e,) if isinstance(e, str)
                                                 else tuple(e))]
        if dims:
            out[jspecs._path_str(p)] = dims
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind,arch", [
    (kind, arch) for kind in ("prefill", "decode", "L1", "L2")
    for arch in (XLSTM, VLM, AUDIO) if (kind, arch) != ("decode", AUDIO)])
@pytest.mark.parametrize("size", ["smoke", "published"])
def test_xlstm_and_front_end_steps_build_at_every_mesh(size, kind, arch,
                                                       mesh_shape):
    """The serve steps (decode not for the encoder-only hubert) and the
    train step under L1 build at every mesh of the tests, at smoke and
    published widths, and every leaf the reference's specs split over
    model is split over model in ``step.in_specs``; L2 (not in the
    reference's table for these archs) builds where its plan is valid:
    a batch that splits over data into the round's microbatches."""
    cfg = (get_smoke_arch if size == "smoke" else get_one_h100_arch)(arch)
    jcfg = (jget_smoke_arch if size == "smoke" else jget_arch)(arch)
    mesh = specs.MeshShape(("data", "model"), mesh_shape)
    if kind in ("prefill", "decode"):
        plan = PREFILL if kind == "prefill" else DECODE
        build = (steps.build_prefill_step if kind == "prefill"
                 else steps.build_decode_step)
        step, _, _ = build(cfg, ShapeConfig("t", 16 if arch != VLM
                                            else cfg.vlm_prefix_len + 16,
                                            4, kind), mesh, False,
                           torch.float32, plan)
        pspecs = tree.flatten(step.in_specs[0], tuples=False)
    else:
        plan = (ShardingPlan(2, ("data",), ()) if kind == "L1"
                else ShardingPlan(2, (), ("data",), fsdp_axes=("data",)))
        seq = 16 + (cfg.vlm_prefix_len if arch == VLM else 0)
        step, _, _, _ = steps.build_train_step(
            cfg, ShapeConfig("t", seq, 8, "train"), mesh, False,
            torch.float32, plan=plan)
        pspecs = step.in_specs[0].params
    want = _split_by_reference(cfg, jcfg, mesh_shape, plan, kind)
    assert want, "the reference splits no leaf over model"
    for path, dims in want.items():
        for d in dims:
            assert pspecs[path][d] == ("model",), (path, pspecs[path])
