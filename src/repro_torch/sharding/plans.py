"""Carry layouts of the client-sharded engine (the JAX package's
``sharding/plans.py``, its client-axis part).

The engine (``core/rounds.py`` with ``mesh=``) runs one process a rank,
and each rank holds one contiguous block of the client axis: rank ``d`` of
``D`` holds clients ``[d * C/D, (d + 1) * C/D)`` (:meth:`ScanCarryPlan.rows`,
where the reference states the same layout as ``PartitionSpec`` s). The
protocol scalars every client agrees on (the round counter, the ledger
head ``prev_hash``) and every metric row are replicated. The cohort
driver's plan (:class:`CohortCarryPlan`) lays out only the ``[A, ...]``
cohort stack; the enrolled population lives in each rank's host store.

The reference's ``train_plan``, ``serve_plan`` and ``batch_divisible``
place an LM's weights with FSDP and tensor axes; they come with the port of
``launch/steps.py``'s mesh builders.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
