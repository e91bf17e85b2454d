"""The serve steps on a mesh (``launch/steps.py``), over gloo ranks on the
CPU, against the one-process port and the JAX package.

The reference's sharded step computes its unsharded function, so every
case is held to the one-device ``transformer.prefill`` / ``decode_step``
of both packages on the same weights (the reference's init, carried
across by ``weights.lm_params_from_jax``) and the same tokens: a prefill,
then 4 teacher-forced decode steps; the ranks' blocks of every position's
logits and of the final state gathered by ``specs.gather_tree``, within
rtol 1e-4 / atol 1e-5. One world of 4 ranks as (data 2, model 2) runs
phi4-mini and qwen3 smoke (qk-norm) with the decode cache split on its
positions over ``model`` (decode crossing a block), a window whose decode
wraps the ring, the long-context plan (batch 1, positions over (data,
model)) and an FSDP plan; one world of 2 ranks runs phi4-mini and qwen3
at (1, 2) and (2, 1), at (1, 2) also minicpm (the tied head on a
vocab-split ``embed``), nemotron (squared ReLU on a column block), the
splits inside a head (one kv head; 3 kv heads for 6 query heads, with the
cache whole on each rank; 3 query heads), and jamba smoke (Mamba, MoE) at
(2, 1) with FSDP.
At (2, 1) the rows split and nothing else: phi4 and qwen3 at 2 rows a
rank are bitwise the one-process port (one torch thread a side); at 1 row
a rank (jamba) they are not, since the CPU's GEMM of one row takes
another kernel (a GEMV) than that of two. With bf16 params and the
cache's positions over data the decode stays within bf16 rounding of the
one-process bf16 decode, and the blocks' combine keeps its log-sum-exp
in fp32. Builds the mesh cannot run raise at build time, the train
step's among them (the xLSTM, VLM and audio families' model splits under
either layout, full-width reductions on model blocks); the Mamba, MLA and
MoE families build (``test_torch_mesh_families.py`` and
``test_torch_train_families.py`` hold them to one process), and the
train step's L2 layout builds for the dense GQA decoders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_dist
from repro.configs import get_smoke_arch as jget_smoke_arch
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import tree
from repro_torch.configs import ShapeConfig, get_arch, get_smoke_arch
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
SEQ_DATA = ShardingPlan(1, (), (), seq_axes=("data",))

# name -> (arch, config changes, mesh, batch, prompt, capacity, prefill
# plan, decode plan)
CASES = {
    # capacity 20: positions 8..11 cross the model blocks' edge at 10
    "phi4 (2, 2)": ("phi4-mini-3.8b", {}, (2, 2), 4, 8, 20, PREFILL,
                    DECODE),
    "qwen3 (2, 2)": ("qwen3-32b", {}, (2, 2), 4, 8, 20, PREFILL, DECODE),
    # a ring of 8 in blocks of 4: positions 10..13 wrap it
    "phi4 window (2, 2)": ("phi4-mini-3.8b", {"sliding_window": 8}, (2, 2),
                           4, 10, 20, PREFILL, DECODE),
    # blocks of 5 over (data, model): positions 8..11 cross 10
    "phi4 long-context (2, 2)": ("phi4-mini-3.8b", {}, (2, 2), 1, 8, 20,
                                 LONG_PREFILL, LONG),
    "phi4 fsdp (2, 2)": ("phi4-mini-3.8b", {}, (2, 2), 4, 8, 20,
                         FSDP_PREFILL, FSDP),
    "phi4 (1, 2)": ("phi4-mini-3.8b", {}, (1, 2), 4, 8, 20, PREFILL,
                    DECODE),
    "qwen3 (1, 2)": ("qwen3-32b", {}, (1, 2), 4, 8, 20, PREFILL, DECODE),
    # the tied head: logits from embed's vocab block
    "minicpm (1, 2)": ("minicpm-2b", {}, (1, 2), 4, 8, 20, PREFILL, DECODE),
    # squared ReLU on the MLP's column block
    "nemotron (1, 2)": ("nemotron-4-15b", {}, (1, 2), 4, 8, 20, PREFILL,
                        DECODE),
    # one kv head: its columns split inside the head, gathered after the
    # product; each rank's 2 query heads read it
    "mqa (1, 2)": ("phi4-mini-3.8b", {"n_kv_heads": 1}, (1, 2), 4, 8, 20,
                   PREFILL, DECODE),
    # 3 kv heads split inside one: gathered; rank 1's query heads 3-5 read
    # kv heads 1, 2, 2 (one kv head a query head); the cache whole on each
    # rank, each attending for its own query heads
    "odd heads (1, 2)": ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 3},
                         (1, 2), 4, 8, 20, PREFILL, PREFILL),
    # 3 query heads split inside one: q, k and v gathered, every head on
    # each rank, the row block of w_o taking its columns
    "cut heads (1, 2)": ("phi4-mini-3.8b", {"n_heads": 3, "n_kv_heads": 3},
                         (1, 2), 4, 8, 20, PREFILL, DECODE),
    "phi4 (2, 1)": ("phi4-mini-3.8b", {}, (2, 1), 4, 8, 20, PREFILL,
                    DECODE),
    "qwen3 (2, 1)": ("qwen3-32b", {}, (2, 1), 4, 8, 20, PREFILL, DECODE),
    "jamba fsdp (2, 1)": ("jamba-1.5-large-398b", {}, (2, 1), 2, 8, 20,
                          FSDP_PREFILL, FSDP),
}
# bf16 params, the decode cache's positions in blocks of 10 over data
# (weights whole, the rows not split): positions 8..11 cross the edge, so
# each step combines two blocks' partial softmaxes
BF16_CASES = {
    "phi4 bf16 sequence split (2, 1)": ("phi4-mini-3.8b", {}, (2, 1), 2, 8,
                                        20, LONG_PREFILL, SEQ_DATA),
}


def _inputs(name):
    """The case's configs, the reference's params and the tokens, drawn
    from a seed of (arch, config changes, batch): cases that differ only
    in mesh or plan serve the same weights and tokens."""
    arch, over, _, b, prompt, _, _, _ = {**CASES, **BF16_CASES}[name]
    cfg = dataclasses.replace(get_smoke_arch(arch), **over)
    jcfg = dataclasses.replace(jget_smoke_arch(arch), **over)
    seed = sum(map(ord, f"{arch} {sorted(over.items())} {b}"))
    params = jax.tree.map(np.asarray, jregistry.init_model(
        jax.random.key(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, prompt + N_STEPS)).astype(np.int32)
    return cfg, jcfg, params, tokens


def _one_process(cfg, params, tokens, max_len, dtype=torch.float32):
    """The one-process port with the params cast to ``dtype``: every
    position's logits and the final state, in fp32."""
    prompt = tokens.shape[1] - N_STEPS
    p = tree.tree_map(lambda x: x.to(dtype), lm_params_from_jax(params,
                                                                "cpu"))
    t = torch.from_numpy(tokens.astype(np.int64))
    logits, state = transformer.prefill(p, cfg, {"tokens": t[:, :prompt]},
                                        max_len=max_len)
    out = [logits]
    for i in range(N_STEPS):
        logits, state = transformer.decode_step(p, cfg, state,
                                                t[:, prompt + i], prompt + i)
        out.append(logits)
    return [x.float().numpy() for x in out], tree.tree_map(
        lambda x: x.float().numpy(), state)


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
            in {**CASES, **BF16_CASES}.items():
        cfg, jcfg, params, tokens = _inputs(name)
        dtype = torch.bfloat16 if name in BF16_CASES else torch.float32
        worlds[mesh[0] * mesh[1]][name] = {
            "cfg": cfg, "mesh": mesh, "params": params, "dtype": dtype,
            "tokens": tokens, "n": N_STEPS, "plan": plan,
            "decode_plan": dplan, "max_len": cap}
        key = (arch, str(sorted(over.items())), b, prompt, cap, dtype)
        if key not in runs:
            runs[key] = (_one_process(cfg, params, tokens, cap, dtype),
                         None if name in BF16_CASES
                         else _reference(jcfg, params, tokens, cap))
        wants[name] = runs[key]
    got = {}
    for n, cases in worlds.items():
        ranks = mesh_lib.run_world(torch_dist.serve_mesh_rank, n,
                                   backend="gloo", device="cpu",
                                   args=(cases,))
        if n == 4:
            got["gathers 4"] = [(r["gathers (2, 2)"],
                                 r["out of order (2, 2)"]) for r in ranks]
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
                         [r[name]["received"] for r in ranks])
    return got, wants


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serve_holds_to_the_one_process_port(served, name):
    got, wants = served
    logits, state, _ = got[name]
    (want_logits, want_state), _ = wants[name]
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _close(g, w, f"{name}: logits at position {i}")
    flat_want = tree.flatten(want_state)
    assert set(tree.flatten(state)) == set(flat_want)
    for path, x in tree.flatten(state).items():
        _close(x, flat_want[path], f"{name}: state {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serve_holds_to_the_reference(served, name):
    got, wants = served
    logits, state, _ = got[name]
    _, (want_logits, want_state) = wants[name]
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _close(g, w, f"{name}: logits at position {i}")
    flat_want = tree.flatten(want_state)
    for path, x in tree.flatten(state).items():
        _close(x, flat_want[path], f"{name}: state {path}")


@pytest.mark.parametrize("name", ["phi4 (2, 1)", "qwen3 (2, 1)"])
def test_rows_split_alone_is_bitwise_the_one_process_port(served, name):
    """At (2, 1) each rank runs its 2 of the 4 rows with whole weights:
    the logits and the state are bitwise the one-process run's (one torch
    thread on either side)."""
    got, wants = served
    logits, state, _ = got[name]
    (want_logits, want_state), _ = wants[name]
    assert all(np.array_equal(g, w) for g, w in zip(logits, want_logits))
    flat_want = tree.flatten(want_state)
    assert all(np.array_equal(x, flat_want[p])
               for p, x in tree.flatten(state).items())


def test_tensor_parallel_collectives_receive_their_analytic_bytes(served):
    """phi4 smoke at (2, 2): a prefill all-reduces over model the
    embedding and, a layer, the attention and MLP outputs (a ring of 2
    receives 2 (n - 1) / n = 1 times each [2, 8, 256] fp32 activation)
    and all-gathers the other rank's kv head for the cache (k and v of 2
    layers x [2, 20, 1, 64] fp32 at the cache's capacity; its rows stay
    split over data). A decode step all-reduces the embedding and, a
    layer, two [2, 256] outputs, and all-gathers a layer the other rank's
    q [2, 128], k and v [2, 64] and the attention partials (output and
    log-sum-exp of 4 heads, [2, 4, 65])."""
    got, _ = served
    for received in got["phi4 (2, 2)"][2]:
        assert received["prefill"] == {"all_reduce": 5 * 2 * 8 * 256 * 4,
                                       "all_gather": 2 * 2 * 2 * 20 * 64 * 4}
        step = {"all_reduce": (1 + 2 * 2) * 2 * 256 * 4,
                "all_gather": 2 * (2 * 128 + 2 * 2 * 64 + 2 * 4 * 65) * 4}
        assert received["decode"] == {k: N_STEPS * v
                                      for k, v in step.items()}


def test_collectives_take_blocks_in_the_order_named(served):
    """On (data 2, model 2) (ranks row-major: rank = 2 data + model) an
    all-gather over axes takes its blocks row-major over their
    coordinates, along the dim asked for, as a ``NamedSharding`` orders
    them; the all-reduce sums over the same ranks. Axes named out of the
    mesh's order raise before any collective."""
    got, _ = served
    for rank, (gathers, out_of_order) in enumerate(got["gathers 4"]):
        d, m = divmod(rank, 2)
        want = {"data": [m, 2 + m], "model": [2 * d, 2 * d + 1],
                ("data", "model"): [0, 1, 2, 3]}
        index = {"data": d, "model": m, ("data", "model"): rank}
        assert set(gathers) == set(want)
        for axes, (gathered, summed, idx) in gathers.items():
            assert gathered.tolist() == [want[axes]], (rank, axes)
            assert summed.item() == sum(want[axes]), (rank, axes)
            assert idx == index[axes], (rank, axes)
        assert out_of_order is not None and "mesh's order" in out_of_order


def _within_bf16(got, want, what):
    """Within 2 bf16 epsilons (2^-7) of ``want``'s largest magnitude: a
    few roundings of the bf16 path, which the one-process decode takes in
    other places (its probabilities rounded before the product with v)."""
    limit = 2 * torch.finfo(torch.bfloat16).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= limit, what


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_sequence_split_decode_holds_to_the_one_process_port(served,
                                                                   name):
    """bf16 params, the cache's positions split over data: the prefill
    is bitwise the one-process port's (weights and rows whole), and each
    decode step, combining the blocks' partials, stays within bf16
    rounding of the one-process bf16 decode."""
    got, wants = served
    logits, state, _ = got[name]
    (want_logits, want_state), _ = wants[name]
    assert np.array_equal(logits[0], want_logits[0])
    for i, (g, w) in enumerate(zip(logits, want_logits)):
        _within_bf16(g, w, f"{name}: logits at position {i}")
    flat_want = tree.flatten(want_state)
    for path, x in tree.flatten(state).items():
        _within_bf16(x, flat_want[path], f"{name}: state {path}")


class _OneBlock:
    """A ``par`` whose sequence gather sees one block: it keeps the
    block's partials."""

    def gather_seq(self, x):
        self.partials = x
        return x[None]


class _Blocks:
    """A ``par`` whose sequence gather returns the blocks' partials."""

    def __init__(self, partials):
        self.partials = partials

    def gather_seq(self, x):
        return torch.stack(self.partials)


def test_bf16_block_combine_keeps_the_log_sum_exp_in_fp32():
    """Two blocks of a bf16 cache whose attention logits sit near 12, so
    that each block's log-sum-exp is near 14, and which weigh alike (v of
    mean +1 in one, -1 in the other): bf16 keeps only 1/16 of a
    log-sum-exp there, which would move the combine's
    weights by several per cent. The partials are combined in fp32, so
    the result is within one bf16 rounding of the one-device ``_sdpa``
    on the same cache."""
    from repro_torch.models import attention

    g = torch.Generator().manual_seed(0)
    b, h, hd, t = 2, 4, 64, 8
    scale = hd ** -0.5
    q = 1.0 + 0.1 * torch.randn(b, 1, h, hd, generator=g)
    k = 12.0 / (hd * scale) + 0.05 * torch.randn(b, 2 * t, h, hd,
                                                  generator=g)
    v = torch.randn(b, 2 * t, h, hd, generator=g)
    v[:, :t] += 1.0
    v[:, t:] -= 1.0
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    valid = torch.arange(2 * t) < t + 5
    partials = []
    for r in range(2):
        one = _OneBlock()
        block = slice(r * t, (r + 1) * t)
        attention._sdpa_blocks(q, k[:, block], v[:, block], valid[block],
                               scale, one)
        partials.append(one.partials)
    lse = partials[0][..., -1]
    assert lse.dtype == torch.float32 and float(lse.min()) > 13
    got = attention._sdpa_blocks(q, k[:, :t], v[:, :t], valid[:t], scale,
                                 _Blocks(partials))
    mask = torch.where(valid, 0.0, float("-inf"))[None, :]
    want = attention._sdpa(q, k, v, mask, scale)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max()
    assert err <= torch.finfo(torch.bfloat16).eps * want.float().abs().max()


def _build(arch, mesh_shape, plan, kind="prefill"):
    cfg = get_smoke_arch(arch)
    mesh = specs.MeshShape(("data", "model"), mesh_shape)
    shape = ShapeConfig("t", 16, 2, kind)
    build = (steps.build_prefill_step if kind == "prefill"
             else steps.build_decode_step)
    return build(cfg, shape, mesh, False, torch.float32, plan)


# a leaf of each family the builder now splits over model: Mamba's
# channels, MLA's heads, the MoE's experts (the leaf's spec, less the
# period axis, and the dim split over model)
SPLIT_LEAVES = {
    "jamba-1.5-large-398b": [("period/j0/mixer/w_in", 1),
                             ("period/j0/mixer/a_log", 0),
                             ("period/j1/moe/w_in", 0)],
    "deepseek-v2-236b": [("prefix/0/mixer/w_uq", 1),
                         ("period/j0/moe/w_in", 0)],
    # the mLSTM's and sLSTM's heads, the VLM's MQA kv columns, the
    # audio encoder's positional conv
    "xlstm-125m": [("period/j0/mixer/w_up", 1), ("period/j0/mixer/f_bias", 0),
                   ("period/j1/mixer/r_o", 0)],
    "paligemma-3b": [("period/j0/mixer/w_k", 1), ("embed", 0)],
    "hubert-xlarge": [("pos_conv/w", 1), ("pos_conv/b", 0)]}


@pytest.mark.parametrize("arch,kind", [
    ("jamba-1.5-large-398b", "prefill"), ("jamba-1.5-large-398b", "decode"),
    ("deepseek-v2-236b", "prefill"), ("deepseek-v2-236b", "decode"),
    ("xlstm-125m", "decode"), ("paligemma-3b", "prefill"),
    ("hubert-xlarge", "prefill")])
def test_unported_splits_raise_at_build_time(arch, kind):
    """At model 2 every family builds, its leaves split over model: the
    Mamba, MLA and MoE families (``tests/test_torch_mesh_families.py``
    holds their steps to one process) and xLSTM, the VLM and the audio
    encoder (``tests/test_torch_mesh_xlstm_frontends.py``)."""
    step, _, plan = _build(arch, (1, 2), DECODE, kind)
    pspecs = tree.flatten(step.in_specs[0], tuples=False)
    for path, dim in SPLIT_LEAVES[arch]:
        lead = 1 if path.startswith("period/") else 0
        assert pspecs[path][lead + dim] == ("model",), (path, pspecs[path])


def test_mla_sequence_split_cache_raises_and_model_one_builds():
    """MLA's latent cache split on its positions over (data, model) (the
    long-context plan) builds, as does model 1 with FSDP."""
    step, _, plan = _build("deepseek-v2-236b", (2, 1), LONG, "decode")
    sspecs = tree.flatten(step.in_specs[1], tuples=False)
    assert sspecs["prefix/0/ckv"] == (None, ("data", "model"), None)
    step, abstract, plan = _build("deepseek-v2-236b", (2, 1), FSDP,
                                  "decode")
    assert plan == FSDP and len(abstract) == 4 and abstract[3] is int


TRAIN_L1 = ShardingPlan(4, ("data",), ())


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "jamba-1.5-large-398b"])
def test_train_step_refuses_the_l2_layout(arch):
    """An L2 plan (clients replicated, FSDP over data) at model extent 2,
    through ``build_train_step`` (and for jamba, whose own train plan is
    L2, ``build_step("train")``): jamba builds, its Mamba and MoE leaves
    split over model as well (``tests/test_torch_train_families.py``
    holds it to one process); the dense GQA decoder with the geometric
    median, which reduces over each whole client model and every leaf is
    an FSDP block, is refused (ROADMAP 9b-2a)."""
    mesh = specs.MeshShape(("data", "model"), (2, 2))
    shape = ShapeConfig("t", 16, 8, "train")
    l2 = ShardingPlan(2, (), ("data",), fsdp_axes=("data",))
    if arch == "jamba-1.5-large-398b":
        step, _, plan, _ = steps.build_train_step(
            get_smoke_arch(arch), shape, mesh, False, torch.float32,
            plan=l2)
        pspecs = step.in_specs[0].params
        assert plan == l2
        assert pspecs["period/j0/mixer/w_in"] == (None, None, ("data",),
                                                  ("model",))
        step, _, plan = steps.build_step("train", get_arch(arch), shape,
                                         mesh, False)   # its own plan: L2
        assert plan.fsdp_axes == ("data",) and not plan.client_axes
        return
    from repro_torch.core import rounds

    spec = rounds.RoundSpec(n_clients=2, tau=1, eta=0.1, robust_agg="geomed")
    with pytest.raises(ValueError, match="9b-2a"):
        steps.build_train_step(get_smoke_arch(arch), shape, mesh, False,
                               torch.float32, spec_override=spec, plan=l2)


def test_train_step_l2_builds_the_dense_gqa_decoder():
    """An L2 plan at model extent 2 builds for phi4-mini: its clients
    whole on every rank, its leaves over (data, model)."""
    mesh = specs.MeshShape(("data", "model"), (2, 2))
    shape = ShapeConfig("t", 16, 8, "train")
    l2 = ShardingPlan(2, (), ("data",), fsdp_axes=("data",))
    step, (state, _), plan, _ = steps.build_train_step(
        get_smoke_arch("phi4-mini-3.8b"), shape, mesh, False, torch.float32,
        plan=l2)
    pspecs = step.in_specs[0].params
    assert plan == l2 and all(s[0] is None for s in pspecs.values())
    assert pspecs["embed"] == (None, ("model",), ("data",))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "deepseek-v2-236b",
                                  "xlstm-125m"])
def test_train_step_refuses_unported_model_splits(arch):
    """An L1 plan at model 2: jamba, deepseek and xLSTM build, their clients over data and their Mamba, MLA, MoE and xLSTM
    leaves over model. At model 1 each builds."""
    shape = ShapeConfig("t", 16, 8, "train")
    mesh22 = specs.MeshShape(("data", "model"), (2, 2))
    step, _, _, _ = steps.build_train_step(
        get_smoke_arch(arch), shape, mesh22, False, torch.float32,
        plan=TRAIN_L1)
    pspecs = step.in_specs[0].params
    assert any(("model",) in sp[1:] for sp in pspecs.values())
    assert all(sp[0] == ("data",) for sp in pspecs.values())
    step, (state, batch), plan, rspec = steps.build_train_step(
        get_smoke_arch(arch), shape,
        specs.MeshShape(("data", "model"), (2, 1)), False, torch.float32,
        plan=TRAIN_L1)
    assert plan == TRAIN_L1 and rspec.n_clients == 4
    assert all(v.shape[0] == 4 for v in state.params.values())
    assert all(s[0] == ("data",) for s in step.in_specs[0].params.values())


@pytest.mark.parametrize("what", ["detect_lazy", "geomed"])
def test_train_step_refuses_full_width_reductions_on_model_blocks(what):
    """The lazy detector's sketch and the geometric median reduce over
    each whole client model: refused at build time on model blocks
    (ROADMAP 9b-2a), built at model 1."""
    from repro_torch.core import rounds

    spec = rounds.RoundSpec(n_clients=4, tau=1, eta=0.1,
                            detect_lazy=what == "detect_lazy",
                            robust_agg="geomed" if what == "geomed"
                            else None)
    shape = ShapeConfig("t", 16, 8, "train")
    cfg = get_smoke_arch("phi4-mini-3.8b")
    with pytest.raises(ValueError, match="9b-2a"):
        steps.build_train_step(cfg, shape,
                               specs.MeshShape(("data", "model"), (2, 2)),
                               False, torch.float32, spec_override=spec,
                               plan=TRAIN_L1)
    steps.build_train_step(cfg, shape,
                           specs.MeshShape(("data", "model"), (2, 1)), False,
                           torch.float32, spec_override=spec, plan=TRAIN_L1)
