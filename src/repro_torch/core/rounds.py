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

``run_blade_fl`` drives K rounds in a Python loop. The mixing matrices the
run needs are built before the loop and uploaded once; the carry and every
metric stay on the device; the run makes one host transfer at the end and
then rebuilds and validates the ledger (``chain.ledger_from_scan``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation, attacks as attacks_lib, chain, \
    detection, dp as dp_lib, lazy as lazy_lib, mining, \
    topology as topology_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.pow_hash import ops as pow_ops

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


def make_local_train(loss_fn: LossFn, spec: RoundSpec):
    """Step 1 stage factory: tau local GD iterations per client, eq. 3.

    Returns ``local_train(params, batch) -> (params, local_losses)``, both
    with a leading client axis. The clients are independent, so the
    gradient of ``sum_c loss_c`` is each client's own gradient. The loss
    returned is the one at the last iteration's pre-update params, as the
    JAX package's ``value_and_grad`` gives it."""

    def local_train(params, batch):
        keys = sorted(params)
        p = [params[k] for k in keys]
        losses = torch.zeros(spec.n_clients, device=p[0].device)
        for _ in range(spec.tau):
            leaves = [w.detach().requires_grad_(True) for w in p]
            with torch.enable_grad():
                losses = loss_fn(dict(zip(keys, leaves)), batch)
                grads = torch.autograd.grad(losses.sum(), leaves)
            p = [w.detach() - spec.eta * g for w, g in zip(leaves, grads)]
        return dict(zip(keys, p)), losses.detach()

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


def make_communicate(spec: RoundSpec, device: DeviceLike = "cuda"):
    """Steps 2+5 stage factory: ``communicate(params, prev_params,
    round_idx, matrix=None) -> (mixed_params, digest, divergence, extra)``.

    One sweep of each leaf of the broadcast set gives the header digest and
    the pre-mix client divergence (Def. 1). With ``spec.detect_lazy`` the
    detector compares the broadcasts with ``prev_params`` (the round's
    starting models) and ``extra`` gets ``n_suspects``. Then the mix runs
    the executor of the ``MixPlan`` that one ``topology.resolve_mix_plan``
    call picks; this factory holds no lowering logic of its own, so
    ``dispatch_plan``'s report and the executed mix cannot drift.
    ``matrix`` is the round's ``W`` on the device (``mix_matrices``), read
    only by ``EXEC_GATHER``. The plan's weights and edge lists go to
    ``device`` once, here."""
    plan = topology_lib.resolve_mix_plan(spec)
    mode = plan.mode
    dev = resolve_device(device)
    weights = (torch.from_numpy(plan.weights).to(dev)
               if plan.weights is not None else None)
    seg_idx = seg_w = None
    if plan.sparse is not None:
        seg_idx = torch.from_numpy(plan.sparse.neighbor_idx).to(
            dev, torch.int64)
        seg_w = torch.from_numpy(plan.sparse.edge_w).to(dev)
    # detect_lazy's sketch projection, drawn once per model width
    projections: Dict[int, torch.Tensor] = {}

    def projection(params):
        width = sum(v[0].numel() for v in params.values())
        if width not in projections:
            projections[width] = detection.sketch_projection(
                width, device=dev)
        return projections[width]

    def communicate(params, prev_params, round_idx, matrix=None):
        digest, divergence = fedavg_ops.digest_divergence_tree(params)
        extra = {}
        if spec.detect_lazy:
            suspects, _ = detection.detect_lazy_round(
                params, prev_params, projection(params),
                threshold_frac=spec.detect_threshold)
            extra["n_suspects"] = suspects.sum().to(torch.int32)
        if mode == topology_lib.EXEC_FEDAVG:
            params = aggregation.mix_all_reduce(params, weights)
        elif mode == topology_lib.EXEC_SEGMENT:
            params = aggregation.mix_segment(params, seg_idx, seg_w)
        elif mode == topology_lib.EXEC_SHIFT_TABLE:
            params = aggregation.mix_rolls(
                params, plan.offsets_table[round_idx % plan.period],
                plan.weight)
        elif mode == topology_lib.EXEC_CLUSTER:
            params = aggregation.mix_cluster(params, plan.n_clusters,
                                             plan.inter_weight)
        elif mode == topology_lib.EXEC_HALO:
            params = aggregation.mix_rolls(params, plan.offsets, plan.weight)
        elif mode == topology_lib.EXEC_MEDIAN:
            params = aggregation.robust_median(params)
        elif mode == topology_lib.EXEC_TRIMMED:
            params = aggregation.robust_trimmed(params, plan.trim)
        elif mode == topology_lib.EXEC_GEOMED:
            params = aggregation.robust_geomedian(params, plan.robust_iters)
        elif mode == topology_lib.EXEC_GATHER:
            if matrix is None:
                raise ValueError("the gather mix needs the round's mixing "
                                 "matrix (rounds.mix_matrices)")
            params = aggregation.mix_gather(params, matrix, weights,
                                            use_kernel=plan.use_kernel)
        else:
            raise ValueError(f"mix mode {mode!r} has no single-device "
                             "executor")
        return params, digest, divergence, extra

    communicate.plan = plan
    return communicate


def make_mine(spec: RoundSpec):
    """Steps 3+4 stage factory: the PoW race and the hash link.

    Returns ``mine(prev_hash, digest, round_idx) -> (mine_metrics,
    new_hash)``. Every client searches its own salted nonce space from
    ``round_idx * 2**20`` (mod 2**32) over the calibrated attempt budget
    (eq. 1); the winner is the argmin hash across the client axis (first
    index on ties) and its nonce seals the new block onto ``prev_hash``.
    On the card the stage is the nonce offset's fill and one launch of the
    mine kernel (``ops.mine_seal``). Bitwise equal to the JAX package's
    stage given the same digest."""

    def mine(prev_hash, digest, round_idx):
        nonce_offset = torch.full((), (int(round_idx) << 20) & mining.MASK,
                                  dtype=torch.int64, device=digest.device)
        return pow_ops.mine_seal(prev_hash, digest, spec.n_clients,
                                 spec.mine_attempts,
                                 nonce_offset=nonce_offset,
                                 difficulty_bits=spec.difficulty_bits)

    return mine


def make_finalize(loss_fn: LossFn, spec: RoundSpec,
                  n_rounds: Optional[int] = None):
    """Closing stage factory: strided global-loss eval + the next carry.

    Returns ``finalize(state, params, new_hash, batch, metrics) ->
    (RoundState, metrics)``. The global loss is the per-client loss
    ``[C]`` of each post-mix model on its own shard; rounds skipped by the
    ``eval_every`` stride report NaN, and ``n_rounds`` (the horizon) forces
    an eval on the last round. ``run_blade_fl`` averages it on the host."""

    def finalize(state, params, new_hash, batch, metrics):
        if spec.eval_global_loss:
            k = state.round_idx + 1
            is_eval = (spec.eval_every <= 1 or k % spec.eval_every == 0
                       or (n_rounds is not None and k == n_rounds))
            if is_eval:
                with torch.no_grad():
                    metrics["global_loss"] = loss_fn(params, batch)
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
                          device: DeviceLike = "cuda"):
    """Build the round: ``(RoundState, batch, matrix=None) -> (RoundState,
    metrics)``.

    ``batch`` leaves have a leading client axis [C, local_batch, ...];
    ``matrix`` is the round's mixing matrix on the device, for the plans
    that read one (``mix_matrices``). The round is the composition of the
    stage factories above; ``device`` is where the communicate stage keeps
    its constants."""
    local_train = make_local_train(loss_fn, spec)
    perturb = make_perturb(spec)
    attack = make_attack(spec)
    communicate = make_communicate(spec, device)
    mine = make_mine(spec)
    finalize = make_finalize(loss_fn, spec, n_rounds)

    def round_fn(state: RoundState, batch,
                 matrix: Optional[torch.Tensor] = None
                 ) -> Tuple[RoundState, Tree]:
        params, local_losses = local_train(state.params, batch)
        params = perturb(params, state.generator)
        params = attack(params, state.generator)
        params, digest, divergence, extra = communicate(
            params, state.params, state.round_idx, matrix)
        mine_metrics, new_hash = mine(state.prev_hash, digest,
                                      state.round_idx)
        metrics = {"local_loss": local_losses, **mine_metrics,
                   "digest": digest, "divergence": divergence, **extra}
        return finalize(state, params, new_hash, batch, metrics)

    return round_fn


# The last decision run_blade_fl took (driver / pow / mix / mix_mode /
# reason), as in the JAX package, so a caller can report the path it ran.
LAST_DISPATCH: Dict[str, str] = {}


def dispatch_plan(spec: RoundSpec, device: DeviceLike = "cuda"
                  ) -> Dict[str, str]:
    """The paths a run of ``spec`` on ``device`` takes, with the JAX
    package's keys: ``driver`` is always ``"loop"`` (the port has no scan
    engine); ``pow`` is ``"kernel"`` when the race runs on the card, else
    ``"plain"`` (its plain version, on the CPU); ``mix`` and ``mix_mode``
    are the resolved ``MixPlan``'s tier and executor, from the same
    ``topology.resolve_mix_plan`` call ``make_communicate`` makes."""
    on_card = torch.device(device).type == "cuda"
    plan = topology_lib.resolve_mix_plan(spec)
    return {"driver": "loop", "reason": "the port drives the rounds in a "
                                        "Python loop",
            "pow": "kernel" if on_card else "plain",
            "mix": plan.mix, "mix_mode": plan.mode}


def metrics_to_host(rows: List[Tree]) -> Dict[str, np.ndarray]:
    """Stack K rounds of device metrics and bring them to the host in ONE
    transfer: every field is packed into one float64 vector (int words
    below 2**32, bools and fp32 values are exact in float64), then each is
    cut out and given back its dtype. Returns field -> [K, ...] array."""
    names = list(rows[0])
    stacked = [torch.stack([r[n] for r in rows]) for n in names]
    packed = torch.cat([s.reshape(-1).to(torch.float64) for s in stacked])
    flat = packed.cpu().numpy()
    out, at = {}, 0
    for name, s in zip(names, stacked):
        size = s.numel()
        dtype = {torch.float32: np.float32, torch.bool: np.bool_}.get(
            s.dtype, np.int64)
        out[name] = flat[at:at + size].reshape(tuple(s.shape)).astype(dtype)
        at += size
    return out


def run_blade_fl(loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                 batch: Tree, n_rounds: int, *, seed: int = 0,
                 device: DeviceLike = "cuda",
                 ledger: Optional[chain.Ledger] = None,
                 topology_matrices=None):
    """Run K integrated rounds; returns (final RoundState, history, ledger).

    ``params_single`` (one model) and ``batch`` (``[C, m, ...]``, reused
    every round: full-batch GD) are moved to ``device``, which defaults to
    the GPU and raises when there is none; pass ``device="cpu"`` to run the
    plain versions of the kernels on the CPU. ``seed`` seeds the CPU
    generator of the lazy / DP / attack draws and, salted, the topology
    stream; ``topology_matrices`` (``[M, C, C]``, round ``k`` mixing with
    ``[k % M]``) replaces the topology's own matrices (the trainer passes
    the table it reports on; tests inject the JAX package's draws). Each history entry
    holds the round's mining fields, ``digest``, ``divergence``,
    ``local_loss_mean``, ``global_loss`` (and ``n_suspects`` under
    ``detect_lazy``) as floats, reduced on the host as in the JAX package.
    The paths taken are recorded in :data:`LAST_DISPATCH`."""
    if int(n_rounds) < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    dev = resolve_device(device)
    LAST_DISPATCH.clear()
    LAST_DISPATCH.update(dispatch_plan(spec, dev))
    params_single = {k: v.to(dev) for k, v in params_single.items()}
    batch = {k: v.to(dev) for k, v in batch.items()}
    table = mix_matrices(spec, n_rounds, seed, dev, topology_matrices)
    generator = torch.Generator(device="cpu").manual_seed(int(seed))
    state = init_state(params_single, spec.n_clients, generator)
    round_fn = make_integrated_round(loss_fn, spec, n_rounds=int(n_rounds),
                                     device=dev)
    rows = []
    for k in range(int(n_rounds)):
        matrix = None if table is None else table[k % table.shape[0]]
        state, metrics = round_fn(state, batch, matrix)
        rows.append(metrics)
    host = metrics_to_host(rows)   # the one host transfer
    glosses = host.pop("global_loss", None)
    llosses = host.pop("local_loss")
    history = [{name: float(v[k]) for name, v in host.items()}
               for k in range(int(n_rounds))]
    for k in range(int(n_rounds)):
        history[k]["local_loss_mean"] = float(np.mean(llosses[k]))
        if glosses is not None:
            history[k]["global_loss"] = float(np.mean(glosses[k]))
    ledger = chain.ledger_from_scan(
        host["digest"], host["winner"], host["nonce"], host["pow_hash"],
        ledger=ledger)
    return state, history, ledger
