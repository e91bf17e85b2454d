"""BLADE-FL integrated round (paper §3.1, Fig. 1) on one device.

One integrated round =
  Step 1  local training: tau full-batch GD iterations per client
          (lazy clients instead plagiarize + add noise, eq. 7)
  Step 2  model broadcast & verification (model digest)
  Step 3  mining: per-client PoW nonce race over a calibrated attempt budget
  Step 4  block validation: the winner's block is hash-linked
  Step 5  local updating: every client adopts the aggregate

The round is composed of six stages, each built once per ``RoundSpec`` by
its ``make_*`` factory, as in the JAX package:

  ``local_train``   Step 1: tau GD iterations per client, all clients at
                    once (``bmm`` over the client axis)
  ``perturb``       Step 1 (lazy, eq. 7) + §6 DP noise on the broadcast set
  ``attack``        the Byzantine clients' broadcasts (``core/attacks.py``)
  ``communicate``   Steps 2+5: digest and divergence in one sweep of the
                    broadcast set, optional lazy detection, then the mix
                    that ``topology.resolve_mix_plan`` picks
  ``mine``          Steps 3+4: PoW race over the client axis + hash link
  ``finalize``      global-loss eval and the next carry

On a GPU the hot spots run hand-written CUDA kernels: the race
(``kernels/pow_hash``), the FedAvg mix, the dense ``fused_mix`` mix and the
digest/divergence sweep (``kernels/fedavg``). The port has one diagnostic
tier, the tolerance one (the JAX package's ``fused_mix`` tier): every path
takes the digest and divergence from the ``digest_div_flat`` sweep, whose
leaf sums are associated differently from ``mining.digest_tree``, so the
ledger forks deterministically from the JAX chain while both chains
validate. Params and losses do not depend on the mining outcome, so they
stay comparable to the reference.

A run (:class:`RoundRunner`) holds static buffers on its device: the carry
(params, ``prev_hash`` and the round index as a device counter), the
mixing matrices and the run's lazy / DP / attack noise, each drawn and
uploaded once before the rounds, and ``[K, ...]`` rows for every metric.
Its ``step`` is one round over those buffers, written back in place. Two
drivers call it, and ``run_blade_fl`` picks one as the JAX package picks
between its loop and its ``lax.scan`` engine (:func:`dispatch_plan`):

  loop    ``step`` in a Python loop: the CPU, per-round batch callables and
          ``jit=False``
  graph   a static batch on the card (:func:`run_blade_fl_scan`): round 0
          runs as a warm round on a side stream, the round is captured as
          a CUDA graph (one per host-side variant, :meth:`RoundRunner.variant`)
          and the other K - 1 rounds are replays

Both read the same buffers, so on one device they run the same kernels on
the same inputs and agree bitwise. Each run makes one host transfer at the
end and then rebuilds and validates the ledger (``chain.ledger_from_scan``).

A third driver, :func:`run_blade_fl_cohort`, runs the round on a cohort of
A of C_enrolled clients a round: one :class:`RoundRunner` at size A whose
carry is loaded from and stored back to a host-side
:class:`PopulationStore` every round (:class:`CohortRunner`).

Client-sharded execution (``mesh=``)
------------------------------------

Every driver and stage factory takes ``mesh``, a ``launch.mesh.ClientMesh``
of this process's rank (the JAX package's ``mesh`` / ``axis_name``): one
process a rank, the client axis split in rank order
(``sharding.plans.ScanCarryPlan``). The carry holds the rank's ``C/D``
client rows; the batch a rank passes is its block of the one-process batch
(``data/pipeline.py``'s sources give it). Per-client work (local training,
the race over the rank's clients with their global ids, the global-loss
eval) runs on the block; every cross-client step goes through the mesh's
collectives, in one of two tiers:

  gather tier (the default; bitwise with one process): the broadcast set
      is all-gathered and the one-device math runs on it on every rank
      (perturb, attack, digest and divergence, detection, the mix), each
      rank keeping its rows; the halo and cluster mixes shift blocks
      instead (``core/aggregation.py``). The best hashes and nonces and the
      per-client losses are gathered too.
  psum tier (``RoundSpec.fast_allreduce``; tolerance): the dense mixes and
      the digest and divergence sum per-rank partials, so the ledger forks
      from the gather tier's while both chains validate.

Every rank draws the run's full noise and matrix tables from the seed,
identically, and runs the full-width perturb and attack on the gathered
set, which is what keeps the gather tier bitwise. The metric rows and the
ledger are replicated; each rank returns them, with the final params
gathered. :func:`dispatch_plan` picks the graph driver only where the
mesh's collectives can be captured in a CUDA graph (NCCL); over gloo the
loop driver runs. The cohort driver's :class:`PopulationStore` is a host
replica on each rank of every row touched so far: after each round every
rank gathers the whole cohort and scatters it into its replica, so any
rank can load any client the next round draws (where the JAX package's
one controller keeps one host store).

The train step on a (data, model) mesh (``launch/steps.py``, the L1
layout) runs this engine on part of the mesh. Its client collectives run
over the plan's client axes only: the engine is handed
``ClientMesh.view(client_axes)``, the line of ranks through this rank
along the data axes, and its code is unchanged. The model axes split each
client's params into blocks (``aggregation.ModelBlocks``); local training
runs the tensor-parallel loss (``registry.client_losses(cfg, par=...)``)
on the rank's ``C/D`` clients, and the fedavg and every other
coordinate-wise mix run on each leaf's block unchanged (clients mix with
clients; the block needs no collective). The digest and the divergence
come from one ``digest_div_flat`` sweep of each block; a split leaf's sum
and residuals are then summed over the model ranks in a fixed order
before ``fold_digest``, two scalars a leaf and client in the psum tier's
way (``mining.digest_tree(model=)``). A gather over ``model`` would move
half of every client's model a round and would still not give one
process's chain, since the tensor-parallel GEMMs already move the
params' last bits: the ledger forks deterministically from the
one-process chain, and both chains validate. The lazy, DP and attack
noise is drawn at each leaf's full shape from the run's generator on
every rank and cut to the rank's block; the race runs on each rank's
clients with their global ids, redundantly on the model ranks of one data
coordinate. ``detect_lazy``'s sketch and the geometric median need a
reduction over each whole client model and raise ``ValueError`` when the
train step is built (``launch.steps.build_train_step`` calls
:func:`refuse_model_split`).

Under the L2 layout (the same step, no client axes) every rank holds
all C clients, each client's params split over the data axes (FSDP) and,
for some leaves, over model: the engine gets no client mesh (``mesh``
None), so fedavg, the mix and the race run on the rank's blocks of all
C clients with no client collective, every rank alike, and
``ModelBlocks`` sums each split leaf's digest and divergence partials
over exactly the axes that leaf is split over. The FSDP gathers and the
batch's reductions run inside the loss (``models/parallel.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels
from repro_torch.core import aggregation, attacks as attacks_lib, chain, \
    detection, dp as dp_lib, lazy as lazy_lib, mining, \
    topology as topology_lib
from repro_torch.device import DeviceLike, resolve_device, resolve_traced
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.pow_hash import ops as pow_ops
from repro_torch.sharding import plans as plans_lib

Tree = Dict[str, torch.Tensor]
# client-stacked params [C, ...] and batch [C, m, ...] -> per-client loss [C]
LossFn = Callable[[Tree, Tree], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """Static configuration of one integrated round (the single-device
    fields of the JAX package's ``RoundSpec``)."""
    n_clients: int
    tau: int                    # local GD iterations (eq. 3)
    eta: float                  # learning rate
    n_lazy: int = 0
    sigma2: float = 0.0         # lazy artificial-noise variance
    dp_sigma: float = 0.0       # DP Gaussian mechanism (§6)
    mine_attempts: int = 1024   # calibrated from beta (allocation.mining_iterations)
    difficulty_bits: int = 8
    eval_global_loss: bool = True
    # gradient accumulation inside each local iteration: each client's
    # batch splits into this many microbatches along its sample axis
    microbatches: int = 1
    # eval stride: compute global_loss only on rounds with
    # (round_idx + 1) % eval_every == 0 (NaN elsewhere); 1 = every round.
    eval_every: int = 1
    # Steps 2+5 communication pattern (core/topology.py); FullMesh is the
    # paper's and runs the FedAvg kernel
    topology: topology_lib.Topology = topology_lib.FullMesh()
    # |D_i| data sizes (length n_clients): W'[i, j] ∝ W[i, j] * w[j]
    data_weights: Optional[Tuple[float, ...]] = None
    # flag near-duplicate broadcasts before the mix (core/detection.py);
    # adds n_suspects to the metrics
    detect_lazy: bool = False
    detect_threshold: float = 0.2
    # dense mixes (EXEC_GATHER) contract through the mix_rows_flat kernel
    # instead of torch.matmul
    fused_mix: bool = False
    # segment mix: None auto (degree * 8 <= C), True forced, False never
    sparse_mix: Optional[bool] = None
    # Byzantine attack on the pre-broadcast params (core/attacks.py)
    attack: Optional[attacks_lib.Attack] = None
    # robust consensus instead of the linear mix: median | trimmed[:t] |
    # geomed[:iters] (topology.parse_robust); None / "mean" keep the mix
    robust_agg: Optional[str] = None
    # the psum tier on a mesh: dense mixes and the digest / divergence sum
    # per-rank partials (aggregation.mix_psum*, mining.digest_tree(mesh=));
    # fp32 reassociated, so results hold to a tolerance and the ledger
    # forks from the gather tier's (both chains validate)
    fast_allreduce: bool = False


class RoundState(NamedTuple):
    params: Tree                # leading client axis C, on the run's device
    generator: torch.Generator  # CPU generator for the lazy / DP draws
    round_idx: int
    prev_hash: torch.Tensor     # int64 word on the run's device


def init_state(params_single: Tree, n_clients: int,
               generator: torch.Generator) -> RoundState:
    dev = next(iter(params_single.values())).device
    return RoundState(
        params=aggregation.replicate(params_single, n_clients),
        generator=generator,
        round_idx=0,
        prev_hash=mining.as_word(chain.GENESIS_HASH, dev),
    )


def _microbatched_grad(loss_fn: LossFn, n_mb: int):
    """The gradient of each client's mean loss over ``n_mb`` microbatches
    (the reference's ``_microbatched_grad``): each client's ``[m, ...]``
    batch splits along its sample axis into ``n_mb`` contiguous blocks of
    m / n_mb, run one after another, each under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant, standing in for the
    reference's per-microbatch ``jax.checkpoint``), so that the activations
    of one microbatch are alive at a time.

    Returns ``grad_fn(params, batch) -> (losses [C], grads)``: params a
    dict of ``[C, ...]`` leaves that require grad, grads a list in
    ``sorted(params)`` order, both the microbatches' mean.

    Each (microbatch, client) runs alone: ``loss_fn`` on that client's
    ``[1, ...]`` slices, under its own checkpoint and its own backward,
    its gradient added into one ``[C, ...]`` buffer a leaf, so that one
    client's activations, gathered FSDP blocks and gradient are alive at
    a time (the clients are independent: the values are the stacked
    call's). The train step on a mesh (``launch/steps.py``) hands each
    rank's loss its block of every logical microbatch, so that the
    microbatch cut here is the reference's."""

    def one_loss(leaves, rows):
        return loss_fn(leaves, rows)[0]

    def grad_fn(params: Tree, batch: Tree):
        m = next(iter(batch.values())).shape[1]
        if m % n_mb:
            raise ValueError(f"a client batch of {m} does not split into "
                             f"{n_mb} microbatches")
        size = m // n_mb
        keys = sorted(params)
        n = params[keys[0]].shape[0]
        grads = [torch.empty_like(params[k]) for k in keys]
        losses = []
        for j in range(n_mb):
            for c in range(n):
                leaves = {k: params[k][c:c + 1].detach().requires_grad_(True)
                          for k in keys}
                mb = {k: v[c:c + 1, j * size:(j + 1) * size]
                      for k, v in batch.items()}
                with torch.enable_grad():
                    l_c = checkpoint(one_loss, leaves, mb,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
                    g_c = torch.autograd.grad(
                        l_c, [leaves[k] for k in keys],
                        materialize_grads=True)
                for acc, g in zip(grads, g_c):
                    if j:
                        acc[c:c + 1].add_(g)
                    else:
                        acc[c:c + 1].copy_(g)
                del g_c
                l_c = l_c.detach()
                if j:
                    losses[c] = losses[c] + l_c
                else:
                    losses.append(l_c)
        scale = 1.0 / n_mb
        for acc in grads:
            acc.mul_(scale)
        return torch.stack(losses) * scale, grads

    return grad_fn


def make_grad(loss_fn: LossFn, spec: RoundSpec):
    """The gradient one local iteration takes: ``grad_fn(params, batch)
    -> (losses [C], grads in sorted(params) order)`` of ``[C, ...]``
    leaves that require grad, over ``spec.microbatches``
    (:func:`_microbatched_grad`) or the whole batch at once."""
    if spec.microbatches > 1:
        return _microbatched_grad(loss_fn, spec.microbatches)

    def grad_fn(params, batch):
        with torch.enable_grad():
            losses = loss_fn(params, batch)
            grads = torch.autograd.grad(
                losses.sum(), [params[k] for k in sorted(params)],
                materialize_grads=True)
        return losses.detach(), grads

    return grad_fn


def make_local_train(loss_fn: LossFn, spec: RoundSpec):
    """Step 1 stage factory: tau local GD iterations per client, eq. 3.

    Returns ``local_train(params, batch) -> (params, local_losses)``, both
    with a leading client axis. The clients are independent, so the
    gradient of ``sum_c loss_c`` is each client's own gradient (zero for a
    leaf the loss does not read, as JAX's ``grad`` gives it). With
    ``spec.microbatches > 1`` each iteration's gradient accumulates over
    that many microbatches (:func:`_microbatched_grad`). The loss returned
    is the one at the last iteration's pre-update params, as the JAX
    package's ``value_and_grad`` gives it."""
    grad_fn = make_grad(loss_fn, spec)

    def local_train(params, batch):
        keys = sorted(params)
        p = [params[k] for k in keys]
        losses = torch.zeros(p[0].shape[0], device=p[0].device)
        for _ in range(spec.tau):
            leaves = [w.detach().requires_grad_(True) for w in p]
            losses, grads = grad_fn(dict(zip(keys, leaves)), batch)
            p = [w.detach() - spec.eta * g for w, g in zip(leaves, grads)]
        return dict(zip(keys, p)), losses

    return local_train


def make_perturb(spec: RoundSpec):
    """Step 1 tail stage factory: what each client broadcasts instead of
    its honest model.

    Returns ``perturb(params, generator, lazy_noise=None, dp_noise=None)``:
    lazy clients plagiarize their source client's fresh model and add
    N(0, sigma^2) disguise noise (eq. 7), then every client optionally adds
    §6 DP Gaussian noise. The noise dicts (leaf-shaped standard normals)
    replace the generator's draws when given. With ``n_lazy == 0`` and
    ``dp_sigma == 0`` the stage is the identity."""
    active = spec.n_lazy > 0 or spec.dp_sigma > 0.0

    def perturb(params, generator, lazy_noise=None, dp_noise=None):
        if not active:
            return params
        params = lazy_lib.apply_lazy(params, spec.n_clients, spec.n_lazy,
                                     spec.sigma2, generator, lazy_noise)
        return dp_lib.privatize(params, spec.dp_sigma, generator, dp_noise)

    perturb.active = active
    return perturb


def make_attack(spec: RoundSpec):
    """Byzantine attack stage factory, composed right after ``perturb``:
    ``attack(params, generator, noise=None) -> params`` replaces the first
    ``spec.attack.n_attackers`` broadcasts. ``ScaledNoise`` draws from
    ``generator`` (the run's, after the round's lazy and DP draws) unless
    ``noise`` is given. ``spec.attack=None`` (or zero attackers) is the
    identity."""
    atk = spec.attack
    active = atk is not None and atk.active
    if active:
        atk._validate(spec.n_clients)

    def attack(params, generator, noise=None):
        if not active:
            return params
        return atk.apply(params, spec.n_clients, generator, noise)

    attack.active = active
    return attack


def mix_matrices(spec: RoundSpec, n_rounds: int, seed: int = 0,
                 device: DeviceLike = "cuda", topology_matrices=None
                 ) -> Optional[torch.Tensor]:
    """The ``[M, C, C]`` mixing matrices a run's communicate stage reads,
    on ``device``; round ``k`` mixes with ``table[k % M]``. None when the
    resolved plan needs no matrix.

    The table is ``topology.round_table`` of the run: the phase table of a
    deterministic topology (M = P for a schedule, 1 otherwise), or
    ``n_rounds`` draws from the seed's ``topology.topology_generator``.
    ``topology_matrices`` (``[M, C, C]``: the caller's own table, or the
    JAX package's ``[K, C, C]`` draws; a stochastic topology needs one
    matrix per round, M = K) replaces it. Built once before the loop: a
    per-round upload from pageable memory would be a host sync."""
    if not topology_lib.resolve_mix_plan(spec).needs_matrix:
        return None
    c = spec.n_clients
    if topology_matrices is not None:
        table = np.asarray(topology_matrices, np.float32)
        m = int(n_rounds) if spec.topology.stochastic else "M"
        if table.ndim != 3 or table.shape[1:] != (c, c) or not len(table) \
                or m not in ("M", len(table)):
            raise ValueError(f"topology_matrices of shape {table.shape}, "
                             f"expected [{m}, {c}, {c}]")
    else:
        table = topology_lib.round_table(
            spec.topology, c, n_rounds,
            topology_lib.topology_generator(seed))
    return torch.from_numpy(np.ascontiguousarray(table)).to(
        resolve_device(device))


def draw_noise(spec: RoundSpec, params: Tree, n_rounds: int,
               generator: torch.Generator, device: DeviceLike = "cuda"
               ) -> Dict[str, Tree]:
    """A run's lazy, DP and attack noise, drawn once before its rounds.

    ``params`` are the client-stacked ``[C, ...]`` leaves. Returns
    ``{stage: {leaf: [n_rounds, rows, ...]}}`` on ``device`` for each
    stage that draws: ``"lazy"`` (``rows = n_lazy``, under ``sigma2 >
    0``), ``"dp"`` (``rows = C``, under ``dp_sigma > 0``) and ``"attack"``
    (``rows = C``, an attack that draws: ``ScaledNoise``). The draws come
    from ``generator`` (``lazy.standard_normal``, one call a leaf) in the
    order the stages draw them round by round when given no noise: per
    round, the lazy leaves in sorted key order, then the DP leaves, then
    the attack's. So a run that reads round ``k`` of this table computes
    what the stages drawing for themselves would, on the CPU and on the
    card alike. The table is uploaded once, like the mixing matrices.

    Its cost is memory, and host time for a large model (the draws are
    serial on the CPU's generator): ``n_rounds * rows`` model-sized slices a
    stage, O(K·C·N) floats for a model of N parameters, held pinned on the
    host and again on the device for the whole run (about 230 MB each for
    Fig. 10's DP sweep at K = 14, C = 20 and the 203 530-parameter MLP),
    growing linearly in K, where drawing round by round held one slice.
    On the ``meta`` device (the dry-run) nothing is drawn: the table is
    meta tensors of its shapes."""
    c = spec.n_clients
    rows = {}
    if spec.n_lazy > 0 and spec.sigma2 > 0.0:
        rows["lazy"] = spec.n_lazy
    if spec.dp_sigma > 0.0:
        rows["dp"] = c
    atk = spec.attack
    if atk is not None and atk.active and atk.draws_noise:
        rows["attack"] = c
    keys = sorted(params)
    dev = resolve_traced(device)
    if dev.type == "meta":
        return {stage: {k: torch.empty((int(n_rounds), r)
                                       + tuple(params[k].shape[1:]),
                                       device=dev)
                        for k in keys}
                for stage, r in rows.items()}
    # drawn straight into the table, made pinned for an upload: at a
    # billion parameters a copy of it takes seconds
    table = {stage: {k: torch.empty((int(n_rounds), r)
                                    + tuple(params[k].shape[1:]),
                                    pin_memory=dev.type == "cuda")
                     for k in keys}
             for stage, r in rows.items()}
    for t in range(int(n_rounds)):
        for stage, leaves in table.items():
            for k in keys:
                # the numbers lazy_lib.standard_normal draws
                torch.randn(tuple(leaves[k].shape[1:]), generator=generator,
                            dtype=torch.float32, out=leaves[k][t])
    if dev.type == "cpu":
        return table
    return {stage: {k: v.to(dev, non_blocking=True)
                    for k, v in leaves.items()}
            for stage, leaves in table.items()}


def _mesh_axes(mesh):
    """``resolve_mix_plan``'s ``mesh_axes`` of a mesh (None: one device)."""
    return None if mesh is None else mesh.axes


def make_communicate(spec: RoundSpec, device: DeviceLike = "cuda",
                     mesh=None, model=None):
    """Steps 2+5 stage factory: ``communicate(params, prev_params,
    round_idx, matrix=None, full=None) -> (mixed_params, digest,
    divergence, extra)``.

    One sweep of each leaf of the broadcast set gives the header digest and
    the pre-mix client divergence (Def. 1). With ``spec.detect_lazy`` the
    detector compares the broadcasts with ``prev_params`` (the round's
    starting models) and ``extra`` gets ``n_suspects``. Then the mix runs
    the executor of the ``MixPlan`` that one ``topology.resolve_mix_plan``
    call picks; this factory holds no lowering logic of its own, so
    ``dispatch_plan``'s report and the executed mix cannot drift.
    ``matrix`` is the round's full ``W`` on the device (``mix_matrices``),
    read by ``EXEC_GATHER`` and ``EXEC_PSUM_DENSE``. The plan's weights and
    edge lists go to ``device`` once, here.

    With ``mesh`` the params are this rank's rows. In the gather tier the
    sweep, the detector and the gathered mixes read the broadcast set
    gathered once (``full``, when the round gathered it already); in the
    psum tier (``plan.fast_diagnostics``) the digest and divergence sum
    per-rank partials (``mining.digest_tree``,
    ``aggregation.client_divergence_psum``) and the detector alone gathers.
    The same plan without a mesh runs the psum tier's math on one device.

    ``model`` (``aggregation.ModelBlocks``): each client's params are this
    rank's model blocks; the digest's leaf sums and the divergence's
    residuals are summed over the blocks (:meth:`ModelBlocks.sum`), the
    mix runs on the blocks as it is. The stages that would need a new
    full-width reduction over the blocks are refused where the train step
    is built (:func:`refuse_model_split`)."""
    plan = topology_lib.resolve_mix_plan(spec, _mesh_axes(mesh))
    mode = plan.mode
    dev = resolve_traced(device)

    def on_device(a, dtype=None):
        return None if a is None else torch.from_numpy(a).to(dev, dtype)

    weights = on_device(plan.weights)
    psum_row = on_device(plan.psum_row)
    seg_idx = seg_w = None
    if plan.sparse is not None:
        seg_idx = on_device(plan.sparse.neighbor_idx, torch.int64)
        seg_w = on_device(plan.sparse.edge_w)
    # detect_lazy's sketch projection, drawn once per model width
    projections: Dict[int, torch.Tensor] = {}

    def projection(params):
        width = sum(v[0].numel() for v in params.values())
        if width not in projections:
            projections[width] = detection.sketch_projection(
                width, device=dev)
        return projections[width]

    def need_matrix(matrix):
        if matrix is None:
            raise ValueError("the dense mix needs the round's mixing "
                             "matrix (rounds.mix_matrices)")
        return matrix

    def communicate(params, prev_params, round_idx, matrix=None, full=None):
        extra = {}
        if plan.fast_diagnostics:
            digest = mining.digest_tree(params, mesh, model)
            divergence = aggregation.client_divergence_psum(params, mesh,
                                                            model)
        else:
            if full is None:
                full = aggregation.client_all_gather(params, mesh)
            digest, divergence = fedavg_ops.digest_divergence_tree(full,
                                                                   model)
        if spec.detect_lazy:
            if full is None:
                full = aggregation.client_all_gather(params, mesh)
            suspects, _ = detection.detect_lazy_round(
                full, aggregation.client_all_gather(prev_params, mesh),
                projection(full), threshold_frac=spec.detect_threshold)
            extra["n_suspects"] = suspects.sum().to(torch.int32)
        if mode == topology_lib.EXEC_PSUM:
            params = aggregation.mix_psum(params, psum_row, mesh=mesh)
        elif mode == topology_lib.EXEC_PSUM_DENSE:
            params = aggregation.mix_psum_dense(
                params, need_matrix(matrix), weights, mesh=mesh,
                use_kernel=plan.use_kernel)
        elif mode == topology_lib.EXEC_FEDAVG:
            params = aggregation.mix_all_reduce(params, weights, mesh=mesh,
                                                full=full)
        elif mode == topology_lib.EXEC_SEGMENT:
            params = aggregation.mix_segment(params, seg_idx, seg_w,
                                             mesh=mesh, full=full)
        elif mode == topology_lib.EXEC_SHIFT_TABLE:
            params = aggregation.mix_shift_halo(
                params, plan.offsets_table[round_idx % plan.period],
                plan.weight, mesh)
        elif mode == topology_lib.EXEC_CLUSTER:
            params = aggregation.mix_cluster(params, plan.n_clusters,
                                             plan.inter_weight, mesh=mesh,
                                             full=full)
        elif mode == topology_lib.EXEC_HALO:
            params = aggregation.mix_neighbor_halo(params, plan.offsets,
                                                   plan.weight, mesh)
        elif mode == topology_lib.EXEC_SHIFT_HALO:
            params = aggregation.mix_shift_halo(params, plan.offsets,
                                                plan.weight, mesh)
        elif mode == topology_lib.EXEC_MEDIAN:
            params = aggregation.mix_median(params, mesh=mesh, full=full)
        elif mode == topology_lib.EXEC_TRIMMED:
            params = aggregation.mix_trimmed(params, plan.trim, mesh=mesh,
                                             full=full)
        elif mode == topology_lib.EXEC_GEOMED:
            params = aggregation.mix_geomedian(params, plan.robust_iters,
                                               mesh=mesh, full=full)
        elif mode == topology_lib.EXEC_GATHER:
            params = aggregation.mix_gather(params, need_matrix(matrix),
                                            weights, mesh=mesh, full=full,
                                            use_kernel=plan.use_kernel)
        else:
            raise ValueError(f"mix mode {mode!r} has no executor")
        return params, digest, divergence, extra

    communicate.plan = plan
    return communicate


def refuse_model_split(spec: RoundSpec, mode: str) -> None:
    """Raise ``ValueError`` for what the round cannot run on model blocks
    without a full-width reduction no path has yet (ROADMAP 9b-2a): the
    lazy detector's sketch (a projection of each whole client model) and
    the geometric median (each client's distance over the whole model).
    Every attack is coordinate-wise and runs on the blocks."""
    why = ("needs a reduction over each whole client model, which the "
           "train step on model blocks does not run (ROADMAP 9b-2a)")
    if spec.detect_lazy:
        raise ValueError(f"detect_lazy's sketch {why}")
    if mode == topology_lib.EXEC_GEOMED:
        raise ValueError(f"the geometric median {why}")


def make_mine(spec: RoundSpec, mesh=None):
    """Steps 3+4 stage factory: the PoW race and the hash link.

    Returns ``mine(prev_hash, digest, round_idx) -> (mine_metrics,
    new_hash)``. Every client searches its own salted nonce space from
    ``round_idx * 2**20`` (mod 2**32) over the calibrated attempt budget
    (eq. 1); the winner is the argmin hash across the client axis (first
    index on ties) and its nonce seals the new block onto ``prev_hash``.
    ``round_idx`` is a Python int, or a one-element int64 tensor on the
    digest's device (a run's round counter, read by a CUDA graph at each
    replay). On the card the stage is the nonce offset's fill (two
    integer ops from a tensor) and one launch of the mine kernel
    (``ops.mine_seal``). Bitwise equal to the JAX package's stage given
    the same digest.

    With ``mesh`` each rank races its own clients, their ids offset by
    ``shard * C/D`` so that the salts are the one-process ones
    (``ops.pow_race``, the flat race), the best hashes and nonces are
    gathered, and every rank takes the same argmin and ``mining.mix_hash``
    link: integers, so bitwise the one-process stage."""
    n_local = spec.n_clients // (1 if mesh is None else mesh.n_shards)
    threshold = mining.difficulty_threshold(spec.difficulty_bits)

    def mine(prev_hash, digest, round_idx):
        if isinstance(round_idx, torch.Tensor):
            nonce_offset = (round_idx.reshape(()) << 20) & mining.MASK
        else:
            nonce_offset = torch.full((), (int(round_idx) << 20)
                                      & mining.MASK, dtype=torch.int64,
                                      device=digest.device)
        if mesh is None:
            return pow_ops.mine_seal(prev_hash, digest, spec.n_clients,
                                     spec.mine_attempts,
                                     nonce_offset=nonce_offset,
                                     difficulty_bits=spec.difficulty_bits)
        shard = aggregation.client_shard_index(mesh)
        ids = torch.arange(n_local, dtype=torch.int64,
                           device=digest.device) + shard * n_local
        best_h, best_n = pow_ops.pow_race(prev_hash, digest, ids,
                                          spec.mine_attempts,
                                          nonce_offset=nonce_offset)
        best_h = aggregation.client_gather(best_h, mesh)
        best_n = aggregation.client_gather(best_n, mesh)
        winner = mining.winner_of(best_h)
        # index by a device tensor without reading it on the host (a CUDA
        # graph captures the stage)
        at = winner.reshape(1)
        pow_hash = best_h.index_select(0, at).reshape(())
        nonce = best_n.index_select(0, at).reshape(())
        metrics = {"winner": winner, "pow_hash": pow_hash, "nonce": nonce,
                   "solved": pow_hash <= threshold}
        return metrics, mining.mix_hash(prev_hash.reshape(()), digest,
                                        nonce)

    return mine


def evaluates(spec: RoundSpec, round_idx: int,
              n_rounds: Optional[int] = None) -> bool:
    """Whether round ``round_idx`` computes the global loss: every
    ``eval_every``-th round, and the last one of a horizon ``n_rounds``."""
    k = round_idx + 1
    return spec.eval_global_loss and (
        spec.eval_every <= 1 or k % spec.eval_every == 0
        or (n_rounds is not None and k == n_rounds))


def make_finalize(loss_fn: LossFn, spec: RoundSpec,
                  n_rounds: Optional[int] = None, mesh=None):
    """Closing stage factory: strided global-loss eval + the next carry.

    Returns ``finalize(state, params, new_hash, batch, metrics) ->
    (RoundState, metrics)``. The global loss is the per-client loss
    ``[C]`` of each post-mix model on its own shard (with ``mesh``, each
    rank's clients', gathered); rounds skipped by the ``eval_every``
    stride report NaN, and ``n_rounds`` (the horizon) forces an eval on the
    last round. ``run_blade_fl`` averages it on the host."""

    def finalize(state, params, new_hash, batch, metrics):
        if spec.eval_global_loss:
            if evaluates(spec, state.round_idx, n_rounds):
                with torch.no_grad():
                    metrics["global_loss"] = aggregation.client_gather(
                        loss_fn(params, batch), mesh)
            else:
                metrics["global_loss"] = torch.full(
                    (spec.n_clients,), float("nan"), device=new_hash.device)
        new_state = RoundState(params=params, generator=state.generator,
                               round_idx=state.round_idx + 1,
                               prev_hash=new_hash)
        return new_state, metrics

    return finalize


def make_integrated_round(loss_fn: LossFn, spec: RoundSpec,
                          n_rounds: Optional[int] = None,
                          device: DeviceLike = "cuda", mesh=None,
                          model=None):
    """Build the round: ``(RoundState, batch, matrix=None, noise=None,
    device_round=None) -> (RoundState, metrics)``.

    ``batch`` leaves have a leading client axis [C, local_batch, ...];
    ``matrix`` is the round's mixing matrix on the device, for the plans
    that read one (``mix_matrices``). ``noise`` (the round's slice of
    :func:`draw_noise`: ``"lazy"``, ``"dp"``, ``"attack"``) replaces the
    stages' draws from ``state.generator``; ``device_round`` (the round
    index as a tensor on the device) replaces ``state.round_idx`` in the
    mine stage's nonce offset. The round is the composition of the stage
    factories above; ``device`` is where the communicate stage keeps its
    constants.

    With ``mesh`` the state's params and the batch are this rank's client
    rows. ``perturb`` and ``attack`` are full-width transforms of the
    broadcast set: when either is active the round gathers the set, runs
    them on it (every rank the same draws) and keeps its rows, and the
    communicate stage reuses the gathered set. ``model``: the params are
    model blocks (:func:`make_communicate`); the noise given must then be
    cut to the blocks, as the train step on a mesh cuts it."""
    local_train = make_local_train(loss_fn, spec)
    perturb = make_perturb(spec)
    attack = make_attack(spec)
    communicate = make_communicate(spec, device, mesh, model)
    mine = make_mine(spec, mesh)
    finalize = make_finalize(loss_fn, spec, n_rounds, mesh)

    def round_fn(state: RoundState, batch,
                 matrix: Optional[torch.Tensor] = None,
                 noise: Optional[Dict[str, Tree]] = None,
                 device_round: Optional[torch.Tensor] = None
                 ) -> Tuple[RoundState, Tree]:
        noise = noise or {}
        params, local_losses = local_train(state.params, batch)
        # perturb and attack transform the whole broadcast set: on a mesh
        # they run on the gathered set, which communicate then reuses
        gathered = mesh is not None and (perturb.active or attack.active)
        if gathered:
            params = aggregation.client_all_gather(params, mesh)
        params = perturb(params, state.generator, noise.get("lazy"),
                         noise.get("dp"))
        params = attack(params, state.generator, noise.get("attack"))
        full = params if gathered else None
        if gathered:
            params = aggregation.client_local_rows(full, mesh)
        params, digest, divergence, extra = communicate(
            params, state.params, state.round_idx, matrix, full=full)
        mine_metrics, new_hash = mine(
            state.prev_hash, digest,
            state.round_idx if device_round is None else device_round)
        local_losses = aggregation.client_gather(local_losses, mesh)
        metrics = {"local_loss": local_losses, **mine_metrics,
                   "digest": digest, "divergence": divergence, **extra}
        return finalize(state, params, new_hash, batch, metrics)

    return round_fn


# The last decision run_blade_fl took (driver / pow / mix / mix_mode /
# reason), as in the JAX package, so a caller can report the path it ran.
LAST_DISPATCH: Dict[str, str] = {}
# The graph driver's last run: ``graphs`` captured, the host seconds of the
# warm round (``warm_s``, with its synchronize) and of the captures
# (``capture_s``), and the ``replays``.
LAST_GRAPH: Dict[str, float] = {}
# The last sharded run on this rank: the analytic bytes its collectives
# received a round, by op (``launch.mesh.ClientMesh.received``), over its
# rounds only (not the final gather of the params).
LAST_RECEIVED: Dict[str, float] = {}


def dispatch_plan(spec: RoundSpec, device: DeviceLike = "cuda",
                  batches=None, *, jit: bool = True,
                  mesh=None) -> Dict[str, str]:
    """The paths a run of ``spec`` on ``device`` takes, with the JAX
    package's keys. Reads only the device's type, so it needs no card.

    ``driver`` is ``"graph"`` (:func:`run_blade_fl_scan`: the round
    captured as CUDA graphs and replayed) for a static batch, stacked or
    not, on the card, and ``"loop"`` (the round step in a Python loop) for
    a per-round batch callable, for ``jit=False`` (the JAX package's name
    for its debugging path) and on the CPU; the two give the same bits on
    one device. ``reason`` says why. ``pow`` is ``"kernel"`` when the race
    runs on the card, else ``"plain"`` (its plain version, on the CPU);
    ``mix`` and ``mix_mode`` are the resolved ``MixPlan``'s tier and
    executor, from the same ``topology.resolve_mix_plan`` call
    ``make_communicate`` makes.

    With ``mesh`` the graph driver needs collectives that a CUDA graph can
    capture: NCCL's. A gloo mesh's collectives go through the host, so its
    ranks run the loop driver on the card too."""
    on_card = torch.device(device).type == "cuda"
    if callable(batches):
        plan = {"driver": "loop", "reason": "per-round batch callable"}
    elif not jit:
        plan = {"driver": "loop", "reason": "jit=False debugging path"}
    elif not on_card:
        plan = {"driver": "loop", "reason": "CPU run: CUDA graphs need the "
                                            "card"}
    elif mesh is not None and mesh.backend != "nccl":
        plan = {"driver": "loop",
                "reason": f"{mesh.backend} ranks: their collectives pass "
                          "through the host, which no CUDA graph captures"}
    else:
        plan = {"driver": "graph",
                "reason": "static batch on the card: a warm round, then "
                          "the round replayed as CUDA graphs"}
    mplan = topology_lib.resolve_mix_plan(spec, _mesh_axes(mesh))
    return {**plan, "pow": "kernel" if on_card else "plain",
            "mix": mplan.mix, "mix_mode": mplan.mode}


def metrics_to_host(rows: Tree) -> Dict[str, np.ndarray]:
    """Bring a run's ``[K, ...]`` metric rows to the host in ONE transfer:
    every field is packed into one float64 vector (int words below 2**32,
    bools and fp32 values are exact in float64), then each is cut out and
    given back its dtype. Returns field -> [K, ...] array."""
    packed = torch.cat([r.reshape(-1).to(torch.float64)
                        for r in rows.values()])
    flat = packed.cpu().numpy()
    out, at = {}, 0
    for name, r in rows.items():
        size = r.numel()
        dtype = {torch.float32: np.float32, torch.bool: np.bool_}.get(
            r.dtype, np.int64)
        out[name] = flat[at:at + size].reshape(tuple(r.shape)).astype(dtype)
        at += size
    return out


def history_and_ledger(rows: Tree, ledger: Optional[chain.Ledger] = None):
    """``(history, ledger)`` of a run from its ``[K, ...]`` metric rows,
    after one host transfer: each history entry holds the round's mining
    fields, ``digest``, ``divergence`` (and ``n_suspects``) as floats and
    ``local_loss_mean`` and ``global_loss`` reduced on the host, as in the
    JAX package; the ledger is rebuilt and validated by
    ``chain.ledger_from_scan``."""
    host = metrics_to_host(rows)   # the one host transfer
    glosses = host.pop("global_loss", None)
    llosses = host.pop("local_loss")
    n_rounds = len(llosses)
    history = [{name: float(v[k]) for name, v in host.items()}
               for k in range(n_rounds)]
    for k in range(n_rounds):
        history[k]["local_loss_mean"] = float(np.mean(llosses[k]))
        if glosses is not None:
            history[k]["global_loss"] = float(np.mean(glosses[k]))
    ledger = chain.ledger_from_scan(
        host["digest"], host["winner"], host["nonce"], host["pow_hash"],
        ledger=ledger)
    return history, ledger


class RoundRunner:
    """One run's static buffers on its device, and the round step over
    them.

    Built once per run: the params go to ``device`` and are replicated to
    the client axis, the mixing matrices (:func:`mix_matrices`) and the
    noise (:func:`draw_noise`, from the CPU generator seeded with ``seed``)
    are made and uploaded, and the round index becomes a device counter.
    :meth:`step` runs one round reading only these buffers, the batch and
    two host-side values of the round (:meth:`variant`), and writes the new
    carry back in place and the round's metrics into ``[K, ...]`` rows at
    the counter. With ``stacked`` the batch is ``[K, C, ...]`` and each
    round takes its slice by the counter.

    With ``mesh`` (and its ``plan``, :func:`carry_plan`) the carry and the
    batch hold this rank's ``C/D`` client rows (a stacked batch ``[K, C/D,
    ...]``); the matrices and the noise are the full tables, drawn alike
    on every rank; the metric rows are the replicated full ones."""

    def __init__(self, loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                 n_rounds: int, *, seed: int = 0,
                 device: DeviceLike = "cuda", stacked: bool = False,
                 topology_matrices=None, mesh=None, plan=None):
        if int(n_rounds) < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        self.spec, self.n_rounds = spec, int(n_rounds)
        self.stacked = bool(stacked)
        self.mesh = mesh
        self.carry = carry_plan(spec.n_clients, mesh, plan)
        self._received = {} if mesh is None else dict(mesh.received)
        self.device = dev = resolve_device(device)
        self.table = mix_matrices(spec, self.n_rounds, seed, dev,
                                  topology_matrices)
        generator = torch.Generator(device="cpu").manual_seed(int(seed))
        self.state = init_state({k: v.to(dev)
                                 for k, v in params_single.items()},
                                self.carry.clients_per_shard, generator)
        self.noise = draw_noise(spec, self.state.params, self.n_rounds,
                                generator, dev)
        self.round_idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rows: Tree = {}
        self.round_fn = make_integrated_round(loss_fn, spec,
                                              n_rounds=self.n_rounds,
                                              device=dev, mesh=mesh)
        self.plan = topology_lib.resolve_mix_plan(spec, _mesh_axes(mesh))

    def check_batch(self, batch: Tree) -> None:
        """Raise unless ``batch`` holds this rank's client rows (at axis 1
        of a stacked batch, whose axis 0 is the K rounds)."""
        want = self.carry.clients_per_shard
        axis = 1 if self.stacked else 0
        leads = {v.shape[axis] for v in batch.values()}
        if leads != {want}:
            where = "this rank's" if self.mesh is not None else "the"
            raise ValueError(f"batch client dims {sorted(leads)} != {want}, "
                             f"{where} client rows")
        if self.stacked:
            _check_stacked(batch, self.n_rounds)

    def variant(self, k: int) -> Tuple[int, bool]:
        """The host-side values round ``k`` reads: the shift-table phase
        of a periodic schedule (0 otherwise) and whether it evaluates the
        global loss (:func:`evaluates`). Rounds of one variant run the same
        device operations, so one CUDA graph serves them all."""
        phase = (k % self.plan.period
                 if self.plan.mode == topology_lib.EXEC_SHIFT_TABLE else 0)
        return phase, evaluates(self.spec, k, self.n_rounds)

    def step(self, k: int, batch: Tree) -> None:
        """Round ``k``: the round's batch, matrix and noise by the device
        counter, the round (``make_integrated_round``), then the carry and
        the metric rows written in place and the counter advanced. ``k`` is
        read only through :meth:`variant`. A run takes K steps: the
        counter indexes the K metric rows."""
        idx = self.round_idx
        if self.stacked:
            batch = {n: v.index_select(0, idx).squeeze(0)
                     for n, v in batch.items()}
        matrix = None
        if self.table is not None:
            m = self.table.shape[0]
            matrix = self.table[0] if m == 1 else \
                self.table.index_select(0, idx % m).squeeze(0)
        noise = {stage: {n: v.index_select(0, idx).squeeze(0)
                         for n, v in leaves.items()}
                 for stage, leaves in self.noise.items()}
        new, metrics = self.round_fn(self.state._replace(round_idx=k), batch,
                                     matrix, noise=noise, device_round=idx)
        for name, v in metrics.items():
            row = self.rows.get(name)
            if row is None:
                row = self.rows[name] = torch.empty(
                    (self.n_rounds,) + tuple(v.shape), dtype=v.dtype,
                    device=self.device)
            row.index_copy_(0, idx, v.unsqueeze(0))
        for name, v in new.params.items():
            self.state.params[name].copy_(v)
        self.state.prev_hash.copy_(new.prev_hash)
        idx.add_(1)

    def finish(self, ledger: Optional[chain.Ledger] = None):
        """``(final RoundState, history, ledger)`` after the last round;
        with a mesh every rank calls it, and the state's params come back
        gathered, ``[C, ...]``."""
        history, ledger = history_and_ledger(self.rows, ledger)
        if self.mesh is not None:
            LAST_RECEIVED.clear()
            LAST_RECEIVED.update({
                op: (n - self._received.get(op, 0)) / self.n_rounds
                for op, n in self.mesh.received.items()})
        params = aggregation.client_all_gather(self.state.params, self.mesh)
        return self.state._replace(params=params, round_idx=self.n_rounds), \
            history, ledger


def carry_plan(n_clients: int, mesh=None,
               plan: Optional[plans_lib.ScanCarryPlan] = None
               ) -> plans_lib.ScanCarryPlan:
    """The carry layout of a run: one block of every client without a
    mesh; on a mesh ``plan`` (else ``plans.scan_carry_plan`` over all of
    its axes), which must split the clients over every rank: the engine's
    collectives span the whole mesh."""
    if mesh is None:
        if plan is not None:
            raise ValueError("a carry plan needs the mesh it was made for")
        return plans_lib.ScanCarryPlan(n_clients=n_clients)
    if plan is None:
        plan = plans_lib.scan_carry_plan(mesh, n_clients, mesh.axis_names)
    if plan.n_clients != n_clients or plan.n_shards != mesh.n_shards:
        raise ValueError(
            f"carry plan of {plan.n_clients} clients over {plan.n_shards} "
            f"shards, the run has {n_clients} clients over the mesh's "
            f"{mesh.n_shards} ranks: shard the clients over every axis")
    return plan


class _CaptureHome:
    """What every run of the graph driver on one device shares.

    ``stream``: the side stream the runs capture and replay on. The
    caching allocator keeps freed blocks for the stream they were used on,
    so with a stream of its own a run (the warm round's autograd buffers,
    its metric rows) would reserve more device memory than the last.
    ``pool``: the memory pool every graph captures into, where a capture
    reuses what earlier runs' graphs freed (a graph's own pool stays
    reserved after the graph is gone, until an ``empty_cache``), so runs of
    one shape reserve nothing after the first (``chip_smoke.py``'s
    ``round_ms`` reads the growth). A capture leaves no tensor of the pool
    alive (the step writes only into buffers made before it), so the graphs
    of one pool may replay in any order, one at a time. ``graphs``:
    the last run's graphs, kept so that the pool is never released: a
    released pool's id cannot be captured into again. Runs share this
    memory, so the graphs of two runs must not replay at once; each run's
    replays end with the caller's stream waiting on them."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []


# device index -> its _CaptureHome
_HOMES: Dict[int, _CaptureHome] = {}


def release_graphs(device: DeviceLike) -> None:
    """Drop the graph driver's home on ``device``: its side stream, its
    pool and the last run's graphs, so that the pool's memory goes back to
    the card at the next ``torch.cuda.empty_cache()`` once no graph of it
    is left; the next run makes a new home. For a run that needs the
    memory earlier runs' graphs hold (a model near the card's size after
    smaller ones); call it between runs, never while a run may replay."""
    _HOMES.pop(resolve_device(device).index, None)


class CapturedRounds:
    """The graph driver's rounds of a :class:`RoundRunner` on the card.

    Made on the device's side stream (:class:`_CaptureHome`): round 0 runs
    as a warm round (a real round, so cuBLAS's handle and workspace,
    autograd, the kernels' tickets and the detector's projection exist
    before any capture), then the step is captured once for each variant
    rounds 1 .. K-1 take (``CUDAGraph.capture_begin`` / ``capture_end``,
    into the device's graph memory pool). :meth:`replay` replays them in
    round order on the same stream.

    The kernels' wrappers count launches as Python calls: the launches
    made while capturing ran nothing and are taken back, and each replay
    adds those of its graph, so ``kernels.launch_counts()`` counts what ran
    on the card."""

    def __init__(self, runner: RoundRunner, batch: Tree):
        dev = runner.device
        home = _HOMES.get(dev.index)
        if home is None:
            home = _HOMES[dev.index] = _CaptureHome(dev)
        self.runner, self.stream = runner, home.stream
        self.replayed = False
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        self.graphs: Dict[Tuple[int, bool], Tuple[object, Dict]] = {}
        with torch.cuda.stream(self.stream):
            t0 = time.perf_counter()
            runner.step(0, batch)
            self.stream.synchronize()
            # a capture allocates from the graph pool and cannot free the
            # blocks the allocator caches: hand back what the warm round
            # left cached, so that a model near the card's memory fits
            torch.cuda.empty_cache()
            self.warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for k in range(1, runner.n_rounds):
                variant = runner.variant(k)
                if variant in self.graphs:
                    continue
                before = kernels.launch_counts()
                graph = torch.cuda.CUDAGraph()
                try:
                    graph.capture_begin(pool=home.pool)
                    try:
                        runner.step(k, batch)
                    finally:
                        graph.capture_end()
                except BaseException:
                    if not home.graphs:   # the failed graph released it
                        home.pool = torch.cuda.graph_pool_handle()
                    raise
                counts = {name: n - before[name] for name, n
                          in kernels.launch_counts().items()}
                kernels.add_launch_counts({name: -n for name, n
                                           in counts.items()})
                self.graphs[variant] = graph, counts
            self.capture_s = time.perf_counter() - t0
        if self.graphs:
            home.graphs = [graph for graph, _ in self.graphs.values()]
        torch.cuda.current_stream(dev).wait_stream(self.stream)

    def replay(self) -> None:
        """Rounds 1 .. K-1, each the replay of its variant's graph. Once:
        a second pass would write past the run's K metric rows."""
        if self.replayed:
            raise RuntimeError("these rounds were replayed already")
        self.replayed = True
        runner = self.runner
        self.stream.wait_stream(torch.cuda.current_stream(runner.device))
        with torch.cuda.stream(self.stream):
            for k in range(1, runner.n_rounds):
                graph, counts = self.graphs[runner.variant(k)]
                graph.replay()
                kernels.add_launch_counts(counts)
        torch.cuda.current_stream(runner.device).wait_stream(self.stream)


def _check_stacked(batch: Tree, n_rounds: int) -> None:
    leads = {v.shape[0] for v in batch.values()}
    if leads != {int(n_rounds)}:
        raise ValueError(f"stacked batch leading dims {sorted(leads)} != "
                         f"n_rounds={int(n_rounds)}")


def run_blade_fl_scan(loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                      batch: Tree, n_rounds: int, *, seed: int = 0,
                      device: DeviceLike = "cuda",
                      ledger: Optional[chain.Ledger] = None,
                      stacked: bool = False, topology_matrices=None,
                      mesh=None, plan=None):
    """The graph driver (the JAX package's ``run_blade_fl_scan``): K
    rounds on the card as one warm round and K - 1 replays of the captured
    round (:class:`CapturedRounds`), with one host transfer at the end.
    ``batch`` is static: one ``[C, ...]`` batch reused every round, or with
    ``stacked`` a ``[K, C, ...]`` stack. Returns ``(final RoundState,
    history, ledger)`` like :func:`run_blade_fl`; the seconds of the warm
    round and of the captures go to :data:`LAST_GRAPH`. With ``mesh`` (an
    NCCL mesh: gloo's collectives cannot be captured) the captured rounds
    hold the mesh's collectives."""
    if callable(batch):
        raise TypeError("run_blade_fl_scan needs a static batch; use "
                        "run_blade_fl for per-round batch callables")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the graph driver runs on the card, not {dev}; "
                         "run_blade_fl drives the CPU in a loop")
    if mesh is not None and mesh.backend != "nccl":
        raise ValueError(f"the graph driver cannot capture {mesh.backend}'s "
                         "collectives; run_blade_fl runs a gloo mesh in a "
                         "loop")
    runner = RoundRunner(loss_fn, spec, params_single, n_rounds, seed=seed,
                         device=dev, stacked=stacked,
                         topology_matrices=topology_matrices, mesh=mesh,
                         plan=plan)
    runner.check_batch(batch)
    batch = {k: v.to(dev) for k, v in batch.items()}
    rounds = CapturedRounds(runner, batch)
    rounds.replay()
    LAST_GRAPH.clear()
    LAST_GRAPH.update(graphs=len(rounds.graphs), warm_s=rounds.warm_s,
                      capture_s=rounds.capture_s,
                      replays=runner.n_rounds - 1)
    return runner.finish(ledger)


def run_blade_fl(loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                 batches, n_rounds: int, *, seed: int = 0,
                 device: DeviceLike = "cuda",
                 ledger: Optional[chain.Ledger] = None, jit: bool = True,
                 stacked: bool = False, topology_matrices=None,
                 mesh=None, plan=None):
    """Run K integrated rounds; returns (final RoundState, history, ledger).

    ``params_single`` (one model) and the batches are moved to ``device``,
    which defaults to the GPU and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels on the CPU.
    ``batches`` is one ``[C, m, ...]`` batch reused every round (full-batch
    GD), with ``stacked`` a ``[K, C, m, ...]`` stack, or a callable
    ``batches(k) -> batch``. :func:`dispatch_plan` picks the driver, as in
    the JAX package: a static batch on the card goes to the graph driver
    (:func:`run_blade_fl_scan`); a callable, ``jit=False`` and the CPU run
    the round step in a Python loop. Both give the same bits on one device.
    ``seed`` seeds the CPU generator of the lazy / DP / attack noise
    (:func:`draw_noise`) and, salted, the topology stream;
    ``topology_matrices`` (``[M, C, C]``, round ``k`` mixing with ``[k %
    M]``) replaces the topology's own matrices (the trainer passes the
    table it reports on; tests inject the JAX package's draws). Each
    history entry holds the round's mining fields, ``digest``,
    ``divergence``, ``local_loss_mean``, ``global_loss`` (and
    ``n_suspects`` under ``detect_lazy``) as floats, reduced on the host
    as in the JAX package. The paths taken are recorded in
    :data:`LAST_DISPATCH`.

    With ``mesh`` (``launch.mesh.ClientMesh``; every rank calls this) the
    client axis is split in rank order by ``plan`` (default: over all of
    the mesh's axes), ``batches`` hold this rank's rows (a callable gives
    them), and each rank returns the gathered params, the replicated
    history and the ledger; the module docstring has the two tiers."""
    if int(n_rounds) < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    dev = resolve_device(device)
    decision = dispatch_plan(spec, dev, batches, jit=jit, mesh=mesh)
    LAST_DISPATCH.clear()
    LAST_DISPATCH.update(decision)
    if decision["driver"] == "graph":
        return run_blade_fl_scan(loss_fn, spec, params_single, batches,
                                 n_rounds, seed=seed, device=dev,
                                 ledger=ledger, stacked=stacked,
                                 topology_matrices=topology_matrices,
                                 mesh=mesh, plan=plan)
    per_round = callable(batches)
    runner = RoundRunner(loss_fn, spec, params_single, n_rounds, seed=seed,
                         device=dev, stacked=stacked and not per_round,
                         topology_matrices=topology_matrices, mesh=mesh,
                         plan=plan)
    if not per_round:
        runner.check_batch(batches)
        batches = {k: v.to(dev) for k, v in batches.items()}
    for k in range(int(n_rounds)):
        batch = ({n: v.to(dev) for n, v in batches(k).items()}
                 if per_round else batches)
        runner.step(k, batch)
    return runner.finish(ledger)


# ---------------------------------------------------------------------------
# Cohort-sampled population driver (enrolled C >> active A)
# ---------------------------------------------------------------------------


class PopulationStore:
    """Host-side parameter store of the enrolled population (the JAX
    package's ``PopulationStore``).

    The device holds only the ``[A, ...]`` stack of a round's cohort. The
    ``n_enrolled`` population lives here, lazily: every client reads the
    shared init model until a round it took part in scatters its own row
    back, so host memory is O(model + touched x model), never O(C_enrolled x
    model).

    ``gather(idx)`` stacks the cohort's rows on ``device`` through one
    staging buffer (pinned when ``device`` is the card) and non-blocking
    copies; the buffer is not refilled while a copy from it may still be in
    flight. ``scatter(idx, params)`` brings a round's cohort back with one
    device-to-host copy and copies each client's row out of it.

    On a client-sharded mesh each rank keeps its own store, a replica of
    every row touched so far: the cohort driver gathers the whole
    post-mix cohort to every rank and scatters all of it, so each rank can
    load whichever of its clients the next round draws. Host memory is
    then O(touched x model) on every rank, where the JAX package's one
    controller keeps one store."""

    def __init__(self, params_single: Tree, n_enrolled: int,
                 device: DeviceLike = "cuda"):
        if n_enrolled < 1:
            raise ValueError("PopulationStore needs n_enrolled >= 1")
        self.n_enrolled = int(n_enrolled)
        self.device = resolve_device(device)
        self.keys = sorted(params_single)
        self._init = {k: params_single[k].detach().to("cpu", torch.float32)
                      .contiguous().clone() for k in self.keys}
        self._rows: Dict[int, Tree] = {}
        # cohort size -> (gather staging, scatter landing): flat host
        # buffers, leaf-major, so each leaf's [A, ...] block is contiguous
        self._buffers: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._uploaded: Optional[torch.cuda.Event] = None

    @property
    def touched(self) -> int:
        """How many clients have materialized their own row."""
        return len(self._rows)

    def materialized_bytes(self) -> int:
        """Host bytes held beyond the shared init model."""
        row_bytes = sum(v.numel() * v.element_size()
                        for v in self._init.values())
        return row_bytes * self.touched

    def _check_idx(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        if idx.ndim != 1:
            raise ValueError(f"cohort index must be 1-D, got {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_enrolled):
            raise ValueError(
                f"cohort indices must lie in [0, {self.n_enrolled}), got "
                f"range [{idx.min()}, {idx.max()}]")
        return idx

    def _views(self, flat: torch.Tensor, a: int) -> Tree:
        """Each leaf's ``[a, ...]`` block of a leaf-major flat buffer."""
        out, at = {}, 0
        for k in self.keys:
            shape = self._init[k].shape
            size = a * self._init[k].numel()
            out[k] = flat[at:at + size].view((a,) + tuple(shape))
            at += size
        return out

    def _buffer(self, a: int, which: int) -> torch.Tensor:
        bufs = self._buffers.get(a)
        if bufs is None:
            n = a * sum(v.numel() for v in self._init.values())
            pin = self.device.type == "cuda"
            bufs = self._buffers[a] = tuple(
                torch.empty(n, dtype=torch.float32, pin_memory=pin)
                for _ in range(2))
        return bufs[which]

    def gather(self, idx, out: Optional[Tree] = None) -> Tree:
        """Rows ``idx`` as ``[len(idx), ...]`` leaves on the store's device:
        written into ``out`` (leaves of that shape there) when given, else
        into new tensors."""
        idx = self._check_idx(idx)
        a = int(idx.size)
        if self._uploaded is not None and not self._uploaded.query():
            self._uploaded.synchronize()   # the last upload still reads it
        staging = self._views(self._buffer(a, 0), a)
        for row, i in enumerate(idx):
            src = self._rows.get(int(i), self._init)
            for k in self.keys:
                staging[k][row].copy_(src[k])
        if out is None:
            out = {k: torch.empty_like(v, device=self.device)
                   for k, v in staging.items()}
        for k in self.keys:
            out[k].copy_(staging[k], non_blocking=True)
        if self.device.type == "cuda":
            self._uploaded = torch.cuda.Event()
            self._uploaded.record(torch.cuda.current_stream(self.device))
        return out

    def scatter(self, idx, cohort_params: Tree) -> None:
        """Write a round's post-mix ``[len(idx), ...]`` cohort back: one
        device-to-host copy (the run's one host sync a round), then each
        client's row copied out, so no row is a view of a reused buffer."""
        idx = self._check_idx(idx)
        leads = {v.shape[0] for v in cohort_params.values()}
        if leads != {idx.size}:
            raise ValueError(
                f"cohort_params leading dims {sorted(leads)} != "
                f"len(idx)={idx.size}")
        a = int(idx.size)
        landing = self._buffer(a, 1)
        flat = torch.cat([cohort_params[k].detach().reshape(-1)
                          for k in self.keys])
        landing.copy_(flat, non_blocking=True)
        if flat.is_cuda:
            torch.cuda.current_stream(flat.device).synchronize()
        host = self._views(landing, a)
        for row, i in enumerate(idx):
            self._rows[int(i)] = {k: host[k][row].clone() for k in self.keys}


def _batch_to(batch, dev: torch.device) -> Tree:
    """A round's batch on ``dev``: numpy leaves as float32 / int64 tensors;
    a host tensor goes to the card from pinned memory without a host sync."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
            v = torch.from_numpy(np.ascontiguousarray(
                v, np.float32 if np.issubdtype(v.dtype, np.floating)
                else np.int64))
        if v.device != dev:
            if dev.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(dev, non_blocking=True)
            else:
                v = v.to(dev)
        out[k] = v
    return out


class CohortRunner:
    """One run of the cohort driver: a :class:`RoundRunner` at cohort size
    A, built once as ``run_blade_fl`` builds it (noise, matrices, counter
    and ``[K, ...]`` metric rows drawn and uploaded once), the population's
    :class:`PopulationStore` and the run's ``[K, A]`` memberships.

    :meth:`step` is one round in four parts, each a method of its own so
    that a caller can time them: :meth:`batch` (the cohort's data on the
    device), :meth:`load` (the store's rows into the runner's carry, in
    place), the runner's step, and :meth:`store_back` (the scatter).

    With ``mesh`` (and a ``plans.CohortCarryPlan``) the runner's carry is
    this rank's block of the cohort: :meth:`batch` and :meth:`load` take
    the rank's rows of the round's memberships, and :meth:`store_back`
    gathers the whole cohort into the rank's replica of the store."""

    def __init__(self, loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                 batches, n_rounds: int,
                 cohort: topology_lib.CohortSchedule, *, seed: int = 0,
                 device: DeviceLike = "cuda",
                 store: Optional[PopulationStore] = None, cohorts=None,
                 topology_matrices=None, mesh=None, plan=None):
        if cohort.cohort_size != spec.n_clients:
            raise ValueError(
                f"spec.n_clients={spec.n_clients} must equal "
                f"cohort.cohort_size={cohort.cohort_size}: the round engine "
                "runs at cohort size")
        dev = resolve_device(device)
        if store is None:
            store = PopulationStore(params_single, cohort.n_enrolled, dev)
        if store.n_enrolled != cohort.n_enrolled:
            raise ValueError(
                f"store holds n_enrolled={store.n_enrolled} but the schedule "
                f"samples from {cohort.n_enrolled}")
        if store.device != dev:
            raise ValueError(f"store gathers onto {store.device}, the run "
                             f"is on {dev}")
        n_rounds = int(n_rounds)
        if cohorts is None:
            table = topology_lib.cohort_table(cohort, n_rounds, seed)
        else:
            table = np.asarray(cohorts)
            if table.shape != (n_rounds, cohort.cohort_size):
                raise ValueError(f"cohorts of shape {table.shape}, expected "
                                 f"[{n_rounds}, {cohort.cohort_size}]")
            for row in table:
                store._check_idx(row)
        if callable(batches):
            self.batch_fn = batches
        else:
            host = _batch_to(batches, torch.device("cpu"))
            leads = {v.shape[0] for v in host.values()}
            if leads != {cohort.n_enrolled}:
                raise ValueError(
                    f"static batches leading dims {sorted(leads)} != "
                    f"n_enrolled={cohort.n_enrolled} (pass a callable "
                    "(round_idx, cohort_idx) -> batch to build per-cohort "
                    "data)")

            def batch_fn(k, idx):
                rows = torch.from_numpy(np.asarray(idx, np.int64))
                return {n: v.index_select(0, rows) for n, v in host.items()}

            self.batch_fn = batch_fn
        self.store, self.table, self.device = store, table, dev
        self.mesh = mesh
        if mesh is None:
            self.rows = slice(None)
        else:
            if plan is None:
                plan = plans_lib.cohort_carry_plan(
                    mesh, cohort.n_enrolled, cohort.cohort_size,
                    mesh.axis_names)
            if plan.n_shards != mesh.n_shards or \
                    plan.cohort_size != cohort.cohort_size:
                raise ValueError(
                    f"cohort plan of {plan.cohort_size} over "
                    f"{plan.n_shards} shards, the run has a cohort of "
                    f"{cohort.cohort_size} over {mesh.n_shards} ranks")
            self.rows = plan.rows(mesh.shard_index)
            plan = plans_lib.ScanCarryPlan(
                n_clients=plan.cohort_size, client_axes=plan.client_axes,
                n_shards=plan.n_shards, axis_sizes=plan.axis_sizes)
        self.runner = RoundRunner(loss_fn, spec, params_single, n_rounds,
                                  seed=seed, device=dev,
                                  topology_matrices=topology_matrices,
                                  mesh=mesh, plan=plan)

    def batch(self, k: int) -> Tree:
        """Round ``k``'s ``[A, ...]`` batch on the device (this rank's
        ``[A/D, ...]`` rows on a mesh)."""
        return _batch_to(self.batch_fn(k, self.table[k][self.rows]),
                         self.device)

    def load(self, k: int) -> None:
        """Round ``k``'s cohort rows into the runner's carry, in place."""
        self.store.gather(self.table[k][self.rows],
                          out=self.runner.state.params)

    def store_back(self, k: int) -> None:
        """Round ``k``'s post-mix cohort back into the store (on a mesh,
        the whole cohort, gathered, into this rank's replica)."""
        self.store.scatter(self.table[k], aggregation.client_all_gather(
            self.runner.state.params, self.mesh))

    def step(self, k: int) -> None:
        batch = self.batch(k)
        self.load(k)
        self.runner.step(k, batch)
        self.store_back(k)

    def finish(self, ledger: Optional[chain.Ledger] = None):
        """``(store, history, ledger)``; each entry records its cohort."""
        _, history, ledger = self.runner.finish(ledger)
        for entry, idx in zip(history, self.table):
            entry["cohort"] = [int(i) for i in idx]
        return self.store, history, ledger


def run_blade_fl_cohort(loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                        batches, n_rounds: int,
                        cohort: topology_lib.CohortSchedule, *, seed: int = 0,
                        device: DeviceLike = "cuda",
                        ledger: Optional[chain.Ledger] = None,
                        store: Optional[PopulationStore] = None,
                        cohorts=None, topology_matrices=None,
                        mesh=None, plan=None):
    """Cohort-sampled population driver (the JAX package's
    ``run_blade_fl_cohort``): K rounds over ``cohort.n_enrolled`` clients of
    which a cohort of ``A = spec.n_clients`` takes part in each round.

    The memberships are drawn before the rounds (``topology.cohort_table``
    of ``seed``; ``cohorts``, ``[K, A]``, replaces them, as
    ``topology_matrices`` replaces the topology's draws). Each round gathers
    the cohort's rows out of the host-side :class:`PopulationStore` into the
    carry of one :class:`RoundRunner` at size A, runs one integrated round
    (training, perturbation, digest, the intra-cohort mix, mining, the hash
    link) and scatters the cohort back: one host sync a round. Nothing
    shaped ``[C_enrolled, ...]`` exists on the device.

    ``batches`` is a callable ``(round_idx, cohort_idx) -> [A, ...]`` batch
    (numpy or tensors), or a static ``[C_enrolled, ...]`` batch kept on the
    host and indexed there each round. With ``A == C_enrolled`` under
    ``prefix`` the run is bitwise :func:`run_blade_fl`'s loop. Returns
    ``(store, history, ledger)``; each history entry also records the
    round's ``"cohort"``. :data:`LAST_DISPATCH` records ``driver="cohort"``.

    With ``mesh`` (every rank calls this; ``plan`` a
    ``plans.CohortCarryPlan``, by default over all of the mesh's axes) each
    rank runs its block of each cohort, ``batches`` is called with the
    rank's client ids, and each rank's store is a full replica
    (:class:`CohortRunner`)."""
    runner = CohortRunner(loss_fn, spec, params_single, batches, n_rounds,
                          cohort, seed=seed, device=device, store=store,
                          cohorts=cohorts, topology_matrices=topology_matrices,
                          mesh=mesh, plan=plan)
    decision = dispatch_plan(spec, runner.device, batches, jit=False,
                             mesh=mesh)
    decision.update(driver="cohort",
                    reason=f"cohort A={cohort.cohort_size} over "
                           f"C_enrolled={cohort.n_enrolled}")
    LAST_DISPATCH.clear()
    LAST_DISPATCH.update(decision)
    for k in range(int(n_rounds)):
        runner.step(k)
    return runner.finish(ledger)
