"""Step builders over any (architecture x input shape x mesh) triple (the
JAX package's ``launch/steps.py``): the arch variant a shape runs, the
shapes an arch skips, the BLADE-FL round of a training cell, and the
serve steps placed on a mesh.

:func:`build_prefill_step` and :func:`build_decode_step` take the
reference's ``(cfg, shape, mesh, multi_pod, dtype, plan=None)`` and return
``(step, abstract inputs, plan)``. The reference hands ``in_shardings`` to
``jax.jit`` and lets GSPMD derive the collectives, so its sharded step
computes the unsharded function; here one process runs each rank
(``launch.mesh``) and the step computes that function from this rank's
blocks by the split the plan's specs imply (``models/parallel.py``):

- the batch rows split over the batch axes (each rank runs its rows);
- FSDP leaves gathered a block at a time, for every block kind;
- over the model axes, Megatron-style tensor parallelism: GQA's query and
  kv head blocks, MLA's head blocks over its whole latents, Mamba's
  channel blocks of d_in (``w_in``'s ``[u | z]`` block gathered and re-cut
  to the rank's channels), the MoE's expert blocks (tokens whole on every
  model rank, the weighted outputs summed: no all-to-all), the dense
  MLPs' column and row blocks (partial sums all-reduced), the vocab-split
  embedding, logits left split on the vocab;
- the mLSTM's and sLSTM's head blocks (d_in's channels: ``w_up``'s
  column block, u gathered once for the projections, the recurrence on
  the rank's heads, the output norm's statistic summed over model), the
  VLM's patches beside its vocab-split lookup and the audio encoder's
  positional conv on its channels;
- a decode cache split on its positions over ``plan.seq_axes`` (GQA's k
  and v, MLA's latent ``ckv`` and ``k_rope``), and the recurrent states
  over the model axes: Mamba's on its channels, the mLSTM's ``C``, ``n``,
  ``m`` and the sLSTM's ``c``, ``n``, ``m``, ``h`` on their heads, each
  conv window on its channels.

A step takes and returns this rank's blocks; ``step.in_specs`` and
``step.out_specs`` are the spec trees that place them (the reference's
``in_shardings`` / ``out_shardings``; ``sharding.specs.shard_tree`` cuts a
rank's blocks, ``gather_tree`` puts the ranks' back together). A
decode-state leaf that the plan splits on a dim no forward here splits
makes the builder raise ``ValueError``.

:func:`build_train_step` takes the reference's ``(cfg, shape, mesh,
multi_pod, dtype, spec_override=None, plan=None)`` and returns ``(step,
(state, batch) abstract, plan, round spec)``: one BLADE-FL round, trained
through autograd over the differentiable collectives of
``models/parallel.py``, under either layout of ``plans.train_plan``:

- L1: the clients over the data axes, each client's params over the
  model axes;
- L2: every client on every rank, each client's params split FSDP-style
  over the data axes (and over ``model`` where the reference splits a
  leaf there too), each client's rows over the same data axes, each rank
  running its block of every one of the reference's microbatches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import aggregation, rounds
from repro_torch.core import topology as topology_lib
from repro_torch.models import registry, ssm as ssm_lib, transformer, \
    xlstm as xlstm_lib
from repro_torch.models.parallel import Parallel
from repro_torch.sharding import plans as plans_lib
from repro_torch.sharding import specs as specs_lib

SLIDING_WINDOW_LONG = 8192  # dense archs x long_500k: windowed-attention variant


def resolve_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The arch's variant for a shape: a causal full-attention arch runs
    long_500k with the sliding-window variant."""
    if shape.name == "long_500k" and cfg.causal and not cfg.subquadratic:
        return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.kind == "decode" and not cfg.has_decode:
        return "encoder-only architecture: no autoregressive decode step"
    return None


def round_spec_for(cfg: ModelConfig, shape: ShapeConfig,
                   plan: specs_lib.ShardingPlan, *, tau: int = 2,
                   mine_attempts: int = 1024) -> rounds.RoundSpec:
    """The round of a training cell under ``plan`` (the reference's
    ``round_spec_for``): ``plan.n_clients`` clients; microbatches of 32
    samples a client under FSDP axes (the L2 giants amortize their weight
    gathers), else of 8, so ``max(1, m // size)`` of them for m =
    ``global_batch / n_clients``; eta 1e-3; one lazy client in 8; sigma2
    1e-4; difficulty 8; no global-loss eval."""
    m = shape.global_batch // plan.n_clients
    size = 32 if plan.fsdp_axes else 8
    return rounds.RoundSpec(
        n_clients=plan.n_clients, tau=tau, eta=1e-3,
        n_lazy=max(plan.n_clients // 8, 0), sigma2=1e-4,
        mine_attempts=mine_attempts, difficulty_bits=8,
        microbatches=max(1, m // size), eval_global_loss=False)


# ---------------------------------------------------------------------------
# Steps on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class MeshStep:
    """One rank's step: ``step(*inputs)`` on this rank's blocks, placed by
    ``in_specs`` (one spec tree an input; a Python int has None) and
    returned placed by ``out_specs``."""
    fn: Callable
    in_specs: tuple
    out_specs: tuple

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _split_dims(spec: specs_lib.Spec, mesh, skip=()) -> list:
    return [(d, specs_lib.split_entry(e, mesh)) for d, e in enumerate(spec)
            if d not in skip and specs_lib.split_entry(e, mesh)]


# decode-state leaf -> the dim (past a period axis) the forwards split:
# the kv caches' and the latent cache's positions, Mamba's channels (its
# scan state ``h`` [B, d_in, ds]), the xLSTM states' heads (``C``, ``n``,
# ``m``, the sLSTM's ``c`` and ``h`` [B, H, hd]), every conv window's
# channels
_STATE_SPLITS = {"k": 1, "v": 1, "ckv": 1, "k_rope": 1, "conv": 2, "h": 1,
                 "C": 1, "n": 1, "m": 1, "c": 1}


def _refuse_unsplit_state(cfg: ModelConfig, mesh, sspecs) -> None:
    """Raise ``ValueError`` naming the first decode-state leaf that the
    plan splits over axes of extent > 1 on a dim past its batch dim where
    no forward here splits it (a guard: every leaf of the zoo's states is
    split where :data:`_STATE_SPLITS` says)."""
    for path, spec in tree_lib.flatten(sspecs, tuples=False).items():
        lead = 1 if path.startswith("period/") else 0
        want = _STATE_SPLITS.get(path.split("/")[-1])
        for d, axes in _split_dims(spec, mesh, skip=(lead,)):
            if want is None or d != lead + want:
                raise ValueError(
                    f"{cfg.name}: the plan splits decode-state leaf {path!r}"
                    f" (dim {d}) over {axes}, where no forward here splits "
                    "it")


def _check_batch(cfg, shape, plan, mesh) -> None:
    if not plans_lib.batch_divisible(cfg, shape, plan, mesh):
        raise ValueError(
            f"a batch of {shape.global_batch} does not split over the batch "
            f"axes {plan.batch_axes} of {dict(mesh.axes)}")


def _logits_spec(cfg: ModelConfig, mesh, plan) -> specs_lib.Spec:
    """The reference's ``logits_sh``: rows over the batch axes, the vocab
    over ``model`` when it divides."""
    return (plan.batch_axes or None,
            ("model",) if cfg.vocab % dict(mesh.axes)["model"] == 0
            else None)


def _seq_axes(state_specs, mesh) -> tuple:
    """The axes of extent > 1 the kv or latent caches' positions are split
    over."""
    for path, spec in tree_lib.flatten(state_specs, tuples=False).items():
        if path.split("/")[-1] in ("k", "ckv"):
            lead = 1 if path.startswith("period/") else 0
            return specs_lib.split_entry(spec[lead + 1], mesh) or ()
    return ()


def _prefill_state_specs(cfg: ModelConfig, plan, state) -> Any:
    """The layout prefill leaves its state in on a rank: rows over the
    batch axes, the kv caches' heads over the model axes where the
    attention computed a block of them, Mamba's conv window and scan
    state on the channels the block computed, the xLSTM states on the
    heads and the conv windows on the channels the block computed (MLA's
    latent cache is whole)."""
    ssm_in, xlstm_in = ssm_lib._dims(cfg)[1], xlstm_lib._dims(cfg)[1]

    def whole(kind, name):   # the split dim's extent on one device
        if kind == "ssm":
            return ssm_in
        return xlstm_in if name == "conv" else cfg.n_heads

    def one(path, x):
        lead = (None,) if path.startswith("period/") else ()
        spec = [plan.batch_axes or None] + [None] * (x.dim() - len(lead) - 1)
        name = path.split("/")[-1]
        kind = specs_lib._kind_of_path(cfg, path)
        if kind == "attn":
            if name in ("k", "v") and x.shape[-2] < cfg.n_kv_heads:
                spec[2] = plan.model_axes
        else:
            dim = _STATE_SPLITS[name]
            if x.shape[len(lead) + dim] < whole(kind, name):
                spec[dim] = plan.model_axes
        return lead + tuple(spec)

    return tree_lib.map_with_path(one, state)


@dataclasses.dataclass(eq=False)
class TrainStep(MeshStep):
    """:class:`MeshStep` of the train step. ``init_state(params, seed)``:
    this rank's round-0 state from one whole model (its flattened leaves,
    ``tree.flatten``, on this rank's device): each leaf's block held by
    every one of this rank's clients, the genesis hash, round 0 and the
    run's CPU generator seeded with ``seed`` (every rank the same).
    ``loss_fn``: the round's per-client loss on this rank's blocks
    (``registry.client_losses`` with the step's tensor-parallel
    context). ``grad_fn(params, batch) -> (losses [C], grads)``: the
    gradient a local iteration takes at ``params`` (this rank's blocks,
    ``[C, ...]``) on ``batch`` (this rank's block under ``in_specs``),
    over the round's microbatches as the step runs them; grads in
    ``sorted(params)`` order."""
    init_state: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    grad_fn: Optional[Callable] = None


def _microbatch_major(batch, mesh, axes, n_mb: int):
    """The rows of each client's ``[C, m, ...]`` batch that this rank runs
    under the L2 layout, from its contiguous block ``[C, m / D, ...]``
    (``train_batch_pspecs``): its 1/D block of every one of the ``n_mb``
    logical microbatches of m / n_mb rows, microbatch after microbatch,
    so that the contiguous cut of ``rounds._microbatched_grad`` takes the
    reference's microbatch j, rows ``[j m / n_mb, (j + 1) m / n_mb)``,
    split over the D ranks in row order. The blocks are all-gathered over
    ``axes`` once a round (the token ids, a few KB)."""
    d, i = mesh.extent(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        # repro-lint: disable=RL302
        full = mesh.all_gather(v, axes, dim=1)
        c, m = full.shape[:2]
        rows = full.reshape((c, n_mb, d, m // (n_mb * d)) + full.shape[2:])
        out[k] = rows[:, :, i].reshape((c, m // d) + full.shape[2:])
    return out


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     multi_pod: bool, dtype=torch.bfloat16,
                     spec_override: Optional[rounds.RoundSpec] = None,
                     plan: Optional[specs_lib.ShardingPlan] = None
                     ) -> tuple:
    """(step, (state abstract, batch abstract), plan, round spec): one
    BLADE-FL round (``rounds.make_integrated_round``) on a mesh, the
    reference's ``build_train_step``: the unsharded integrated round,
    computed from this rank's blocks.

    ``plan`` (default ``plans.train_plan``) gives the layout.

    L1 (``plan.client_axes``): the clients split over the client axes; the
    model axes split each client's params as ``param_pspecs`` gives them,
    and tensor parallelism runs inside each client's loss
    (``registry.client_losses(cfg, par=...)``: every family's forward
    with differentiable collectives and a vocab-parallel cross-entropy,
    ``models/parallel.py``). The round's client collectives
    run over the client axes alone (the engine gets
    ``mesh.view(plan.client_axes)``). At model extent 1 the step is the
    client-sharded engine of ``launch.train --devices``.

    L2 (no client axes): all C clients on every rank; each client's
    params split over the FSDP axes (which must be the batch axes) and,
    where ``param_pspecs`` says so, over ``model``. Each client's loss
    gathers a block's FSDP leaves just before the block runs, under
    autograd (their gradients reduce-scattered back,
    ``Parallel.unshard``), sums the gradients of the other leaves over the
    batch axes (``Parallel.enter_params``) and is the mean over all the
    client's rows, the MoE load-balance loss over the whole batch too
    (``Parallel.batch_loss``): the same loss on every rank. Each rank's
    batch block (``in_specs``: contiguous rows, as the reference's
    ``train_batch_pspecs``) is re-cut once a round to its block of every
    logical microbatch (:func:`_microbatch_major`: the tokens all-gathered
    over the batch axes), so ``round_spec_for``'s microbatches of 32 are
    the reference's. The engine gets no client mesh: fedavg, the mix and
    the race run on the rank's blocks of all C clients with no client
    collective, the race on every rank alike.

    Under both, the digest and the divergence sum each split leaf's
    partials over exactly the axes that leaf is split over
    (``aggregation.ModelBlocks``; ``core/rounds.py``'s docstring).
    ``spec_override`` replaces ``round_spec_for(cfg, shape, plan)``; its
    ``n_clients`` must be the plan's.

    ``step(state, batch, matrix=None, noise=None) -> (state, metrics)`` on
    this rank's blocks (``step.in_specs`` / ``out_specs``; the state's
    params are the flattened leaves, ``[C, ...]`` under their specs): the
    round's noise is drawn from ``state.generator`` at each leaf's full
    shape, in the order ``rounds.draw_noise`` draws a round's, and cut to
    the rank's blocks, unless ``noise`` (one round's, ``{stage: {leaf:
    [rows, ...]}}`` at the full shapes) is given; ``matrix`` is the
    round's mixing matrix for a topology that reads one
    (``rounds.mix_matrices``). ``metrics`` (``local_loss`` [C], ``winner``,
    ``pow_hash``, ``nonce``, ``solved``, ``digest``, ``divergence``) are
    replicated on every rank. ``step.init_state(params, seed)`` makes a
    rank's round-0 state.

    The round stages that would need a reduction over each whole client
    model (``detect_lazy``, the geometric median) raise ``ValueError`` on
    split leaves."""
    cfg = resolve_cfg(cfg, shape)
    plan = plan or plans_lib.train_plan(cfg, shape, mesh, multi_pod)
    rspec = spec_override or round_spec_for(cfg, shape, plan)
    l2 = not plan.client_axes
    if rspec.n_clients != plan.n_clients or plan.n_clients < 2:
        raise ValueError(f"a round of {rspec.n_clients} clients under a "
                         f"plan of {plan.n_clients} (the train step needs "
                         "two or more, the same in both)")
    if l2 and set(plan.fsdp_axes) != set(plan.batch_axes):
        raise ValueError(f"the L2 layout splits the params over the FSDP "
                         f"axes {plan.fsdp_axes} and the rows over the same "
                         f"axes; the batch axes are {plan.batch_axes}")
    params_abs = registry.params_specs(cfg, dtype, n_clients=plan.n_clients)
    batch_abs = registry.train_batch_specs(cfg, shape, dtype,
                                           n_clients=plan.n_clients)
    flat_abs = tree_lib.flatten(params_abs)
    pspecs = tree_lib.flatten(
        specs_lib.param_pspecs(cfg, mesh, plan, params_abs), tuples=False)
    # each client's leaves: the specs less the client dim
    mspecs = {k: spec[1:] for k, spec in pspecs.items()}
    par = Parallel(mesh, plan, mspecs, batch_loss=l2)
    model_axes, batch_axes = par.model_axes, par.batch_axes
    m = shape.global_batch // plan.n_clients
    n_mb = max(1, rspec.microbatches)
    if l2 and m % (n_mb * math.prod(dict(mesh.axes)[a]
                                    for a in batch_axes)):
        raise ValueError(f"{n_mb} microbatches of a client's {m} rows do "
                         f"not split over the batch axes {plan.batch_axes}")
    # each split leaf -> the axes (mesh order) its block is split over
    split = {}
    for k, spec in mspecs.items():
        axes = {a for _, ax in _split_dims(spec, mesh) for a in ax}
        if axes:
            split[k] = tuple(a for a in mesh.axis_names if a in axes)
    if split:
        rounds.refuse_model_split(rspec, topology_lib.resolve_mix_plan(
            rspec, tuple((a, n) for a, n in mesh.axes
                         if a in plan.client_axes) or None).mode)
    # at model extent 1 under L1 the loss is one device's: the
    # client-sharded engine
    loss_fn = registry.client_losses(
        cfg, par=par if model_axes or l2 else None)
    grad = rounds.make_grad(loss_fn, rspec)
    recut = l2 and bool(batch_axes) and n_mb > 1
    engine: dict = {}

    def build():   # the mesh's views, on the first call (a rank's mesh)
        engine["round"] = rounds.make_integrated_round(
            loss_fn, rspec, device=mesh.device,
            mesh=mesh.view(plan.client_axes) if plan.client_axes else None,
            model=aggregation.ModelBlocks(mesh, split) if split else None)

    def rows(batch):
        return (_microbatch_major(batch, mesh, batch_axes, n_mb) if recut
                else batch)

    def train(state: rounds.RoundState, batch, matrix=None, noise=None):
        if not engine:
            build()
        if noise is None:   # on a meta mesh shapes alone: nothing drawn
            noise = {stage: {k: v[0] for k, v in leaves.items()}
                     for stage, leaves in rounds.draw_noise(
                         rspec, flat_abs, 1, state.generator,
                         "meta" if mesh.device.type == "meta" else "cpu"
                     ).items()}
        noise = {stage: {k: specs_lib.shard_leaf(
                     v, (None,) + mspecs[k], mesh).to(mesh.device)
                     for k, v in leaves.items()}
                 for stage, leaves in noise.items()}
        return engine["round"](state, rows(batch), matrix, noise=noise)

    def grad_fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        return grad(leaves, rows(batch))

    def init(params, seed: int):
        n_local = plan.n_clients // mesh.extent(plan.client_axes)
        blocks = {k: specs_lib.shard_leaf(params[k], mspecs[k], mesh)
                  for k in sorted(params)}
        return rounds.init_state(
            blocks, n_local,
            torch.Generator(device="cpu").manual_seed(int(seed)))

    state_specs = rounds.RoundState(params=pspecs, generator=None,
                                    round_idx=None, prev_hash=())
    metric_specs = {"local_loss": (None,), "winner": (), "pow_hash": (),
                    "nonce": (), "solved": (), "digest": (),
                    "divergence": ()}
    state_abs = rounds.RoundState(
        params=flat_abs, generator=torch.Generator, round_idx=int,
        prev_hash=torch.empty((), dtype=torch.int64, device="meta"))
    step = TrainStep(train, (state_specs, specs_lib.train_batch_pspecs(
        cfg, plan, batch_abs)), (state_specs, metric_specs),
        init_state=init, loss_fn=loss_fn, grad_fn=grad_fn)
    return step, (state_abs, batch_abs), plan, rspec


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       multi_pod: bool, dtype=torch.bfloat16,
                       plan: Optional[specs_lib.ShardingPlan] = None, *,
                       decode_plan: Optional[specs_lib.ShardingPlan] = None,
                       max_len: int = 0) -> tuple:
    """(step, (params, batch) abstract, plan). ``step(params, batch) ->
    (last-token logits, decode state)`` on this rank's blocks (``mesh``:
    its ``launch.mesh.ClientMesh``). The state leaves in the layout
    ``decode_state_pspecs`` gives under ``decode_plan`` (default: the
    prefill's plan), at a capacity of ``max_len`` positions (default
    ``shape.seq_len``; the decode shape's ``seq_len``): the kv heads the
    rank's attention computed are gathered over the model axes where the
    decode layout holds every head, and each rank keeps its block of
    positions. The logits are placed as the decode step's."""
    cfg = resolve_cfg(cfg, shape)
    plan = plan or plans_lib.serve_plan(cfg, shape, mesh, multi_pod)
    decode_plan = decode_plan or plan
    max_len = max_len or shape.seq_len
    _check_batch(cfg, shape, plan, mesh)
    params_abs = registry.params_specs(cfg, dtype)
    batch_abs = registry.prefill_batch_specs(cfg, shape, dtype)
    pspecs = specs_lib.param_pspecs(cfg, mesh, plan, params_abs)
    sspecs = specs_lib.decode_state_pspecs(
        cfg, mesh, decode_plan,
        registry.decode_state_specs(cfg, shape.global_batch, max_len, dtype))
    _refuse_unsplit_state(cfg, mesh, sspecs)
    par = Parallel(mesh, plan, tree_lib.flatten(pspecs, tuples=False))

    def prefill(params, batch):
        logits, state = transformer.prefill(params, cfg, batch,
                                            max_len=max_len, par=par)
        src = _prefill_state_specs(cfg, plan, state)
        state = tree_lib.tree_map(
            lambda x, a, b: specs_lib.relayout(x, a, b, mesh), state,
            src, sspecs)
        return logits, state

    step = MeshStep(prefill, (pspecs, specs_lib.serve_batch_pspecs(
        plan, batch_abs)), (_logits_spec(cfg, mesh, plan), sspecs))
    return step, (params_abs, batch_abs), plan


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      multi_pod: bool, dtype=torch.bfloat16,
                      plan: Optional[specs_lib.ShardingPlan] = None
                      ) -> tuple:
    """(step, (params, state, token, pos) abstract, plan). ``step(params,
    state, token, pos) -> (logits, state)`` on this rank's blocks, ``pos``
    a Python int, the state updated in place; the cache holds
    ``shape.seq_len`` positions, split over ``plan.seq_axes`` where they
    divide."""
    cfg = resolve_cfg(cfg, shape)
    plan = plan or plans_lib.serve_plan(cfg, shape, mesh, multi_pod)
    _check_batch(cfg, shape, plan, mesh)
    params_abs = registry.params_specs(cfg, dtype)
    dec = registry.decode_input_specs(cfg, shape, dtype)
    pspecs = specs_lib.param_pspecs(cfg, mesh, plan, params_abs)
    sspecs = specs_lib.decode_state_pspecs(cfg, mesh, plan, dec["state"])
    _refuse_unsplit_state(cfg, mesh, sspecs)
    par = Parallel(mesh, plan, tree_lib.flatten(pspecs, tuples=False),
                   seq_axes=_seq_axes(sspecs, mesh))

    def decode(params, state, token, pos: int):
        return transformer.decode_step(params, cfg, state, token, pos,
                                       par=par)

    step = MeshStep(decode, (pspecs, sspecs, (plan.batch_axes or None,),
                             None),
                    (_logits_spec(cfg, mesh, plan), sspecs))
    return step, (params_abs, dec["state"], dec["token"], dec["pos"]), plan


def build_step(kind: str, cfg, shape, mesh, multi_pod,
               dtype=torch.bfloat16):
    """The reference's dispatch: ``"train"`` (:func:`build_train_step`),
    ``"prefill"`` or ``"decode"``; returns (step, abstract inputs,
    plan)."""
    if kind == "train":
        step, abs_in, plan, _ = build_train_step(cfg, shape, mesh,
                                                 multi_pod, dtype)
        return step, abs_in, plan
    if kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, multi_pod, dtype)
    return build_decode_step(cfg, shape, mesh, multi_pod, dtype)
