"""The serve steps on a mesh for the Mamba, MLA and MoE families
(``launch/steps.py``), over gloo ranks on the CPU, against the one-process
port and the JAX package.

jamba smoke (Mamba, GQA, MoE), deepseek-v2 smoke (MLA, MoE with a shared
expert) and kimi-k2 smoke (GQA, MoE with a shared expert) are served at
(data, model) = (1, 2), (2, 2) and (1, 4): a prefill with the batch over
data, then 4 teacher-forced decode steps with the cache's positions over
model (capacity 20: blocks of 10 at model 2, of 5 at model 4, so the
steps at 8..11 cross a block edge). Each rank holds its channels of
Mamba's d_in (at model 4 a rank's column block of ``w_in`` is half of u
or half of z, so a re-cut right only at model 2 fails), its heads of MLA,
its experts of the MoE (tokens whole on every model rank). Beside them:
the long-context plan (batch 1, positions over (data, model)) for
deepseek and jamba, an FSDP plan for jamba, and deepseek with 3 experts
(not divisible by 2: the experts run whole beside split heads and a split
shared expert), deepseek with 3 heads (MLA's blocks cut a head: the
weights gathered), jamba with d_in 127 (the Mamba block run whole beside
split leaves), and deepseek's prefill in MLA's absorbed form (held to
the reference's materialized one). Every case's ranks' blocks of each position's logits and
of the final state are gathered (``specs.gather_tree``) and held to the
one-device ``transformer.prefill`` / ``decode_step`` of both packages on
the same weights (the reference's init) and tokens, at rtol 1e-4 / atol
1e-5. The bytes a rank receives are held to ``chip_smoke.serve_received``
(the count phase 12 holds the card to). The serve steps and the train
step (L1, L2) build for the three at each mesh, and so do the serve
steps of xLSTM, the VLM and the audio encoder, their leaves over model.
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
from repro.configs import get_smoke_arch as jget_smoke_arch
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import tree
from repro_torch.configs import ShapeConfig, get_smoke_arch
from repro_torch.configs.base import MoEConfig, SSMConfig
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
FSDP_PREFILL = ShardingPlan(1, (), ("data",), fsdp_axes=("data",))
FSDP = ShardingPlan(1, (), ("data",), fsdp_axes=("data",),
                    seq_axes=("model",))

JAMBA, DEEPSEEK, KIMI = ("jamba-1.5-large-398b", "deepseek-v2-236b",
                         "kimi-k2-1t-a32b")
# deepseek smoke with 3 routed experts: not divisible by model 2
THREE_EXPERTS = {"moe": MoEConfig(n_experts=3, top_k=2, n_shared=1,
                                  d_ff=128, every=1)}
# name -> (arch, config changes, mesh, batch, prompt, capacity, prefill
# plan, decode plan)
CASES = {
    f"{short} {mesh}": (arch, {}, mesh, 4, 8, 20, PREFILL, DECODE)
    for short, arch in (("jamba", JAMBA), ("deepseek", DEEPSEEK),
                        ("kimi", KIMI))
    for mesh in ((1, 2), (2, 2), (1, 4))}
CASES.update({
    # blocks of 5 over (data, model): positions 8..11 cross 10
    "deepseek long-context (2, 2)": (DEEPSEEK, {}, (2, 2), 1, 8, 20,
                                     LONG_PREFILL, LONG),
    "jamba long-context (2, 2)": (JAMBA, {}, (2, 2), 1, 8, 20, LONG_PREFILL,
                                  LONG),
    # experts over model and their F over data, Mamba's rows over data
    "jamba fsdp (2, 2)": (JAMBA, {}, (2, 2), 4, 8, 20, FSDP_PREFILL, FSDP),
    "deepseek 3 experts (1, 2)": (DEEPSEEK, THREE_EXPERTS, (1, 2), 4, 8, 20,
                                  PREFILL, DECODE),
    # MLA's prefill in its absorbed form on head blocks
    "deepseek absorbed (1, 2)": (DEEPSEEK, {}, (1, 2), 4, 8, 20, PREFILL,
                                 DECODE),
    # 3 heads over 2 ranks: w_uq's and w_uk's blocks cut a head, so the
    # weights are gathered and each rank runs every head, w_o's row block
    # taking its columns
    "deepseek cut heads (1, 2)": (DEEPSEEK, {"n_heads": 3, "n_kv_heads": 3},
                                  (1, 2), 4, 8, 20, PREFILL, DECODE),
    # d_in 127 does not split over 2 while w_in's 254 columns do: the
    # Mamba block gathers them and runs every channel, beside split
    # attention and experts
    "jamba whole channels (1, 2)": (
        JAMBA, {"d_model": 127, "ssm": SSMConfig(d_state=8, d_conv=4,
                                                 expand=1)},
        (1, 2), 4, 8, 20, PREFILL, DECODE),
})
ABSORBED = ("deepseek absorbed (1, 2)",)


def _inputs(name):
    """The case's configs, the reference's params and the tokens, drawn
    from a seed of (arch, config changes, batch): cases that differ only
    in mesh or plan serve the same weights and tokens."""
    arch, over, _, b, prompt, _, _, _ = CASES[name]
    cfg = dataclasses.replace(get_smoke_arch(arch), **over)
    jover = {k: (getattr(jconfigs, type(v).__name__)(
        **dataclasses.asdict(v)) if dataclasses.is_dataclass(v) else v)
        for k, v in over.items()}
    jcfg = dataclasses.replace(jget_smoke_arch(arch), **jover)
    seed = sum(map(ord, f"{arch} {sorted(over.items())} {b}"))
    params = jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, prompt + N_STEPS)).astype(np.int32)
    return cfg, jcfg, params, tokens


def _one_process(cfg, params, tokens, max_len, absorbed=False):
    """The one-process port: every position's logits and the final
    state."""
    prompt = tokens.shape[1] - N_STEPS
    p = lm_params_from_jax(params, "cpu")
    t = torch.from_numpy(tokens.astype(np.int64))
    with torch_dist.mla_absorbed(absorbed):
        logits, state = transformer.prefill(
            p, cfg, {"tokens": t[:, :prompt]}, max_len=max_len)
    out = [logits]
    for i in range(N_STEPS):
        logits, state = transformer.decode_step(p, cfg, state,
                                                t[:, prompt + i], prompt + i)
        out.append(logits)
    return [x.numpy() for x in out], tree.tree_map(lambda x: x.numpy(),
                                                   state)


def _reference(jcfg, params, tokens, max_len):
    """The JAX package's prefill and decode steps."""
    prompt = tokens.shape[1] - N_STEPS
    logits, state = jtransformer.prefill(params, jcfg,
                                         {"tokens": tokens[:, :prompt]},
                                         max_len=max_len)
    out = [np.asarray(logits)]
    for i in range(N_STEPS):
        logits, state = jtransformer.decode_step(
            params, jcfg, state, tokens[:, prompt + i], prompt + i)
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def served():
    """Every case on its mesh (one world of 4 ranks, one of 2), gathered;
    with the one-process port's and the reference's results."""
    worlds = {4: {}, 2: {}}
    wants, runs = {}, {}
    for name, (arch, over, mesh, b, prompt, cap, plan, dplan) \
            in CASES.items():
        cfg, jcfg, params, tokens = _inputs(name)
        worlds[mesh[0] * mesh[1]][name] = {
            "cfg": cfg, "mesh": mesh, "params": params,
            "dtype": torch.float32, "tokens": tokens, "n": N_STEPS,
            "plan": plan, "decode_plan": dplan, "max_len": cap,
            "absorbed": name in ABSORBED}
        key = (arch, str(sorted(over.items())), b, prompt, cap,
               name in ABSORBED)
        if key not in runs:
            runs[key] = (_one_process(cfg, params, tokens, cap,
                                      name in ABSORBED),
                         _reference(jcfg, params, tokens, cap))
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
                for i in range(N_STEPS + 1)]
            state = specs.gather_tree(
                [tree.tree_map(torch.from_numpy, r[name]["state"])
                 for r in ranks], first["state_specs"], mesh)
            got[name] = ([x.numpy() for x in logits],
                         tree.tree_map(lambda x: x.numpy(), state),
                         [r[name]["received"] for r in ranks],
                         first["state_specs"])
    return got, wants


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _held(got, want_logits, want_state, name):
    logits, state = got[:2]
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _close(g, w, f"{name}: logits at position {i}")
    flat_want = tree.flatten(want_state)
    assert set(tree.flatten(state)) == set(flat_want)
    for path, x in tree.flatten(state).items():
        _close(x, flat_want[path], f"{name}: state {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_family_mesh_serve_holds_to_the_one_process_port(served, name):
    got, wants = served
    (want_logits, want_state), _ = wants[name]
    _held(got[name], want_logits, want_state, name)


@pytest.mark.parametrize("name", list(CASES))
def test_family_mesh_serve_holds_to_the_reference(served, name):
    got, wants = served
    _, (want_logits, want_state) = wants[name]
    _held(got[name], want_logits, want_state, name)


@pytest.mark.parametrize("name,leaf,dim", [
    ("jamba (1, 4)", "period/j0/h", 2),
    ("jamba (1, 4)", "period/j0/conv", 3),
    ("deepseek (2, 2)", "prefix/0/ckv", 1),
    ("deepseek long-context (2, 2)", "period/j0/ckv", 2)])
def test_decode_state_is_split_where_the_forwards_split_it(served, name,
                                                           leaf, dim):
    """Mamba's conv window and scan state on their channels over model,
    MLA's latent cache on its positions over the decode plan's axes."""
    got, _ = served
    spec = tree.flatten(got[name][3], tuples=False)[leaf]
    want = CASES[name][7].seq_axes if "ckv" in leaf else ("model",)
    assert spec[dim] == want, (leaf, spec)


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (its phase 12 holds the card
    to the same analytic count, ``serve_received``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["jamba (1, 2)", "jamba (1, 4)",
                                  "deepseek (2, 2)",
                                  "deepseek long-context (2, 2)",
                                  "kimi (2, 2)"])
def test_family_collectives_receive_their_analytic_bytes(served, name):
    """Each rank's bytes received by op, in the prefill and over the
    decode steps, exactly ``chip_smoke.serve_received``'s count of them
    (its docstring: Mamba's ``[u | z]`` gather and its two partial sums a
    layer, MLA's output sum and the decode's gathered queries and
    partials, the MoE's one sum a layer, the routing's gathered choices,
    the embedding and the kv caches' gathers)."""
    got, _ = served
    arch, over, mesh, b, prompt, cap, plan, dplan = CASES[name]
    cfg = dataclasses.replace(get_smoke_arch(arch), **over)
    want = _chip_smoke().serve_received(cfg, mesh, b, prompt, cap, plan,
                                        dplan, N_STEPS)
    for r, received in enumerate(got[name][2]):
        assert received == want, (r, received, want)


def _build(arch, mesh_shape, plan, kind="prefill"):
    cfg = get_smoke_arch(arch)
    mesh = specs.MeshShape(("data", "model"), mesh_shape)
    shape = ShapeConfig("t", 16, 4, kind)
    build = (steps.build_prefill_step if kind == "prefill"
             else steps.build_decode_step)
    return build(cfg, shape, mesh, False, torch.float32, plan)


# a leaf of each of the last three families that the builders split over
# model (the spec less the period axis, the dim split): the mLSTM's and
# sLSTM's head blocks, their states' heads, the VLM's MQA kv columns and
# tied vocab, the audio encoder's positional conv and heads
NINE_B_3B_LEAVES = {
    "xlstm-125m": [("period/j0/mixer/w_up", 1), ("period/j0/mixer/w_i", 1),
                   ("period/j1/mixer/r_z", 0), ("period/j1/mixer/w_down", 0),
                   ("period/j0/mixer/o_norm/scale", 0)],
    "paligemma-3b": [("period/j0/mixer/w_k", 1), ("embed", 0)],
    "hubert-xlarge": [("pos_conv/w", 1), ("period/j0/mixer/w_q", 1)]}
NINE_B_3B_STATES = {"xlstm-125m": [("period/j0/C", 1), ("period/j1/h", 1),
                                   ("period/j1/conv", 2)]}


@pytest.mark.parametrize("arch,kind", [
    ("xlstm-125m", "prefill"), ("xlstm-125m", "decode"),
    ("paligemma-3b", "prefill"), ("paligemma-3b", "decode"),
    ("hubert-xlarge", "prefill")])
def test_9b_3b_families_raise_at_build_time(arch, kind):
    """xLSTM, the VLM and the audio encoder split over model build: their
    leaves and the xLSTM states split over model
    (``tests/test_torch_mesh_xlstm_frontends.py`` holds their steps to one
    process)."""
    step, _, _ = _build(arch, (1, 2), DECODE, kind)
    pspecs = tree.flatten(step.in_specs[0], tuples=False)
    for path, dim in NINE_B_3B_LEAVES[arch]:
        lead = 1 if path.startswith("period/") else 0
        assert pspecs[path][lead + dim] == ("model",), (path, pspecs[path])
    sspecs = tree.flatten(step.out_specs[1], tuples=False)
    for path, dim in NINE_B_3B_STATES.get(arch, []):
        assert sspecs[path][1 + dim] == ("model",), (path, sspecs[path])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", [JAMBA, DEEPSEEK, KIMI])
@pytest.mark.parametrize("kind", ["prefill", "decode", "L1", "L2"])
def test_family_steps_build_at_every_mesh(kind, arch, mesh_shape):
    """The serve steps and the train step under both layouts build for
    the three families at every mesh of the tests, and place a leaf of
    each family over model (Mamba's channels, MLA's or GQA's heads, the
    MoE's experts)."""
    cfg = get_smoke_arch(arch)
    mesh = specs.MeshShape(("data", "model"), mesh_shape)
    if kind in ("prefill", "decode"):
        step, _, _ = _build(arch, mesh_shape, PREFILL if kind == "prefill"
                            else DECODE, kind)
        pspecs = tree.flatten(step.in_specs[0], tuples=False)
    else:
        plan = (ShardingPlan(2, ("data",), ()) if kind == "L1"
                else ShardingPlan(2, (), ("data",), fsdp_axes=("data",)))
        step, _, _, _ = steps.build_train_step(
            cfg, ShapeConfig("t", 16, 8, "train"), mesh, False,
            torch.float32, plan=plan)
        pspecs = step.in_specs[0].params
    mixer = "period/j0/mixer/" + ("w_in" if arch == JAMBA else
                                  "w_uq" if arch == DEEPSEEK else "w_q")
    experts = "period/j1/moe/w_in" if arch == JAMBA else \
        "period/j0/moe/w_in"
    for path in (mixer, experts):
        assert ("model",) in pspecs[path], (path, pspecs[path])
