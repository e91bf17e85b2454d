"""Layouts on a mesh (the JAX package's ``sharding/plans.py``): the carry
layouts of the client-sharded engine, and the per-(architecture x input
shape x mesh) placement of an LM's steps.

The engine (``core/rounds.py`` with ``mesh=``) runs one process a rank,
and each rank holds one contiguous block of the client axis: rank ``d`` of
``D`` holds clients ``[d * C/D, (d + 1) * C/D)`` (:meth:`ScanCarryPlan.rows`,
where the reference states the same layout as ``PartitionSpec`` s). The
protocol scalars every client agrees on (the round counter, the ledger
head ``prev_hash``) and every metric row are replicated. The cohort
driver's plan (:class:`CohortCarryPlan`) lays out only the ``[A, ...]``
cohort stack; the enrolled population lives in each rank's host store.

:func:`train_plan` and :func:`serve_plan` give an LM step's
``specs.ShardingPlan`` by the reference's rules: the client count C and
layout are an explicit table (:data:`_TRAIN_TABLE`; BLADE-FL needs C model
replicas somewhere, the protocol's real memory price at scale): small and
mid archs run the client-sharded layout (L1, C = data extent), giants run
client-replicated + FSDP (L2) with few clients; serving shards the batch
over the data axes, adds FSDP past :data:`_FSDP_SERVE_BYTES` of
tensor-parallel params a device, and shards the decode cache's sequence.
``launch/steps.py`` builds the serve steps and the train step (both
layouts) on these plans.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.specs import ShardingPlan, _extent

# arch -> (layout, single-pod C, multi-pod C)
_TRAIN_TABLE = {
    "xlstm-125m": ("L1", 16, 32),
    "qwen3-32b": ("L2", 4, 4),
    "nemotron-4-15b": ("L1", 16, 32),
    "jamba-1.5-large-398b": ("L2", 2, 2),
    "paligemma-3b": ("L1", 16, 32),
    "hubert-xlarge": ("L1", 16, 32),
    "phi4-mini-3.8b": ("L1", 16, 32),
    "kimi-k2-1t-a32b": ("L2", 2, 2),   # > HBM at 256 chips (the reference)
    "minicpm-2b": ("L1", 16, 32),
    "deepseek-v2-236b": ("L2", 2, 2),
}

# serve: FSDP when the tensor-parallel params a device exceed ~12 GB
_FSDP_SERVE_BYTES = 12e9


def _client_axis_extents(mesh, client_axes: Tuple[str, ...],
                         what: str) -> Tuple[int, Tuple[int, ...]]:
    """Shared ``client_axes`` validation of the carry-plan builders:
    non-empty, no duplicates, every name an axis of ``mesh`` (a
    ``launch.mesh.ClientMesh``). Returns the shard count with the per-axis
    extents, so a divisibility error can spell out the axis product."""
    if not client_axes:
        raise ValueError(
            f"client_axes must name at least one mesh axis (an empty tuple "
            f"would replicate the {what} and silently run every client on "
            "every shard)")
    dupes = sorted({a for a in client_axes if client_axes.count(a) > 1})
    if dupes:
        raise ValueError(
            f"client_axes {tuple(client_axes)} name mesh axes more than "
            f"once ({', '.join(map(repr, dupes))}); each axis shards the "
            "client dimension at most once")
    extents = dict(mesh.axes)
    for a in client_axes:
        if a not in extents:
            raise ValueError(f"mesh has no axis {a!r}: {extents}")
    sizes = tuple(int(extents[a]) for a in client_axes)
    n_shards = 1
    for s in sizes:
        n_shards *= s
    return n_shards, sizes


def _axis_product(client_axes: Tuple[str, ...],
                  sizes: Tuple[int, ...]) -> str:
    """``"8 (= pod:2 x data:4)"``: the full axis product for error text."""
    n = 1
    for s in sizes:
        n *= s
    if len(sizes) == 1:
        return f"{n} ({client_axes[0]}:{sizes[0]})"
    prod = " x ".join(f"{a}:{s}" for a, s in zip(client_axes, sizes))
    return f"{n} (= {prod})"


def block_rows(n_clients: int, n_shards: int, index: int) -> slice:
    """The rows of client block ``index`` of ``n_shards`` equal blocks."""
    local = n_clients // n_shards
    return slice(index * local, (index + 1) * local)


@dataclasses.dataclass(frozen=True)
class ScanCarryPlan:
    """Layout of the K-round engine's carry on a client-sharded mesh: the
    client-stacked leaves (params and the per-client batch) split along
    ``client_axes`` into ``n_shards`` equal blocks in rank order, the
    round counter, ``prev_hash`` and the metric rows replicated.
    ``axis_sizes`` are the mesh's extents along ``client_axes``, for
    ``topology.resolve_mix_plan``'s halo and cluster decisions."""
    n_clients: int
    client_axes: Tuple[str, ...] = ("data",)
    n_shards: int = 1
    axis_sizes: Tuple[int, ...] = ()

    @property
    def clients_per_shard(self) -> int:
        return self.n_clients // self.n_shards

    def rows(self, index: int) -> slice:
        """Client rows of shard ``index``: ``[C, ...]`` leaves, and axis 1
        of a stacked ``[K, C, ...]`` batch."""
        return block_rows(self.n_clients, self.n_shards, index)


def scan_carry_plan(mesh, n_clients: int,
                    client_axes: Tuple[str, ...] = ("data",)
                    ) -> ScanCarryPlan:
    """Build and validate the carry layout of ``mesh``. ``n_clients`` must
    divide evenly over the extent of ``client_axes``: every shard carries
    the same static client block, which keeps the per-rank program
    identical (and the gather tier bitwise with one process; the psum tier
    slices its weight and column blocks by the same shard index)."""
    client_axes = tuple(client_axes)
    n_shards, sizes = _client_axis_extents(mesh, client_axes, "client axis")
    if n_clients % n_shards != 0:
        raise ValueError(
            f"n_clients={n_clients} not divisible by the client-axis "
            f"extent {_axis_product(client_axes, sizes)}; pick C as a "
            "multiple of the device count")
    return ScanCarryPlan(n_clients=n_clients, client_axes=client_axes,
                         n_shards=n_shards, axis_sizes=sizes)


@dataclasses.dataclass(frozen=True)
class CohortCarryPlan:
    """Carry layout of the cohort driver (``core.rounds
    .run_blade_fl_cohort``): only the ``[A, ...]`` active-cohort stack is
    split along ``client_axes``; the ``n_enrolled`` population has no
    device layout, it lives in each rank's host ``PopulationStore``."""
    n_enrolled: int
    cohort_size: int
    client_axes: Tuple[str, ...] = ("data",)
    n_shards: int = 1
    axis_sizes: Tuple[int, ...] = ()

    @property
    def clients_per_shard(self) -> int:
        return self.cohort_size // self.n_shards

    def rows(self, index: int) -> slice:
        """Cohort rows of shard ``index``."""
        return block_rows(self.cohort_size, self.n_shards, index)


def cohort_carry_plan(mesh, n_enrolled: int, cohort_size: int,
                      client_axes: Tuple[str, ...] = ("data",)
                      ) -> CohortCarryPlan:
    """Build and validate the cohort-carry layout of ``mesh``. Only
    ``cohort_size`` must divide over the client-axis extent; the enrolled
    population is host-side and never sharded."""
    client_axes = tuple(client_axes)
    n_shards, sizes = _client_axis_extents(mesh, client_axes, "cohort")
    if not 1 <= cohort_size <= n_enrolled:
        raise ValueError(
            f"cohort_size={cohort_size} must lie in "
            f"[1, n_enrolled={n_enrolled}]")
    if cohort_size % n_shards != 0:
        raise ValueError(
            f"cohort_size={cohort_size} not divisible by the client-axis "
            f"extent {_axis_product(client_axes, sizes)}; pick A as a "
            "multiple of the device count")
    return CohortCarryPlan(n_enrolled=n_enrolled, cohort_size=cohort_size,
                           client_axes=client_axes, n_shards=n_shards,
                           axis_sizes=sizes)


def gathered_mix_models_moved(n_clients: int, n_shards: int) -> int:
    """Models RECEIVED per device per round by a gathered (all-gather +
    replicated math + keep-local-rows) mix: ``C - C/D`` remote client
    blocks, the price of every robust reducer and of the bitwise linear
    gather paths. The psum tier moves O(1) models instead, which robust
    order statistics cannot reclaim (they are not sum-associative)."""
    if n_shards < 1 or n_clients % n_shards:
        raise ValueError(
            f"n_clients={n_clients} must divide over n_shards={n_shards}")
    return n_clients - n_clients // n_shards


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def train_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
               multi_pod: bool) -> ShardingPlan:
    """The training layout of ``cfg.name`` (:data:`_TRAIN_TABLE`): L1
    shards the clients over the data axes (aggregation is the all-reduce
    over the client axis); L2 replicates the few clients, shards the
    params over the data axes (FSDP) and the per-client batch likewise."""
    layout, c_single, c_multi = _TRAIN_TABLE[cfg.name]
    c = c_multi if multi_pod else c_single
    daxes = data_axes(multi_pod)
    if layout == "L1":
        return ShardingPlan(n_clients=c, client_axes=daxes, batch_axes=(),
                            fsdp_axes=())
    return ShardingPlan(n_clients=c, client_axes=(), batch_axes=daxes,
                        fsdp_axes=daxes)


def serve_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
               multi_pod: bool) -> ShardingPlan:
    """The serving layout: prefill shards the batch over the data axes;
    decode at a batch of 16 or more shards it likewise and the cache's
    sequence over ``model``; a smaller decode batch (long_500k's 1) is
    replicated and the cache's sequence sharded over every axis. FSDP over
    the data axes when bf16 params split 16 ways exceed
    :data:`_FSDP_SERVE_BYTES`."""
    daxes = data_axes(multi_pod)
    tp_bytes = cfg.param_count() * 2 / 16
    fsdp = daxes if tp_bytes > _FSDP_SERVE_BYTES else ()
    if shape.kind == "prefill":
        return ShardingPlan(n_clients=1, client_axes=(), batch_axes=daxes,
                            fsdp_axes=fsdp)
    if shape.global_batch >= 16:  # decode_32k: batch over data, seq over model
        return ShardingPlan(n_clients=1, client_axes=(), batch_axes=daxes,
                            fsdp_axes=fsdp, seq_axes=("model",))
    seq = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShardingPlan(n_clients=1, client_axes=(), batch_axes=(),
                        fsdp_axes=fsdp, seq_axes=seq)


def batch_divisible(cfg: ModelConfig, shape: ShapeConfig,
                    plan: ShardingPlan, mesh) -> bool:
    """Whether each client's batch splits evenly over the plan's batch
    axes."""
    if plan.batch_axes:
        per = shape.global_batch // max(plan.n_clients, 1)
        return per % _extent(mesh, plan.batch_axes) == 0
    return True
