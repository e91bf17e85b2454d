"""Communication topologies for the model-broadcast step (paper §3.1 Step 2).

The paper broadcasts every model to every client and every client adopts
the same aggregate: a full mesh, the row-stochastic mixing matrix
``W = 11^T / C``. Partial or lossy broadcasts (ring gossip, per-round link
dropout, partial participation, schedules) are expressed by one
abstraction:

    a ``Topology`` yields a row-stochastic mixing matrix ``W [C, C]`` per
    round; client i's post-communication model is
    ``sum_j W[i, j] * model_j`` (``aggregation.mix``).

This is a host-side numpy copy of the JAX package's ``core/topology.py``:
every deterministic ``W`` is built the same way in float32 and equals the
reference's bit for bit. Stochastic topologies draw from an explicit CPU
``torch.Generator`` where the reference takes a PRNG key. Matrices stay on
the host; the round driver uploads the ones a run needs once, before its
loop (``rounds.mix_matrices``).

Besides its matrix, every topology advertises how its mix executes
(:meth:`Topology.lowering`, a :class:`MixLowering` kind), and
:func:`resolve_mix_plan` turns a round spec into the :class:`MixPlan` whose
``mode`` (an ``EXEC_*`` executor) ``rounds.make_communicate`` switches on.
This file is the only place that compares lowering kinds (repro-lint
RL205).

With ``fast_allreduce=True`` (``RoundSpec.fast_allreduce``) ``FullMesh``,
and any deterministic topology whose matrix has uniform rows
(:meth:`Topology.uniform_row`), advertise the :data:`PSUM` kind: a sum of
locally pre-weighted rows over the ranks of a client-sharded mesh, which
reassociates fp32 and so lives in the tolerance tier.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# MixLowering kinds
ALL_REDUCE = "all_reduce"
NEIGHBOR_PERMUTE = "neighbor_permute"
GATHER = "gather"
# a sum over the ranks of locally pre-weighted rows (aggregation.mix_psum),
# advertised only under fast_allreduce (tolerance tier)
PSUM = "psum"
# per-client neighbor index lists + edge weights (aggregation.mix_segment)
SEGMENT = "segment"
# dense intra-cluster mean + ring exchange of cluster means
CLUSTER = "cluster"
# a robust consensus reducer over the whole broadcast set (robust_agg)
ROBUST = "robust"

# Executor strategies a resolved MixPlan selects; disjoint from the kinds,
# so no kind comparison exists outside this module.
EXEC_FEDAVG = "exec_fedavg"            # aggregation.mix_all_reduce
EXEC_PSUM = "exec_psum"                # aggregation.mix_psum (tolerance)
EXEC_PSUM_DENSE = "exec_psum_dense"    # aggregation.mix_psum_dense (tol.)
EXEC_SEGMENT = "exec_segment"          # aggregation.mix_segment
EXEC_SHIFT_TABLE = "exec_shift_table"  # one shift set per schedule phase
EXEC_HALO = "exec_halo"                # aggregation.mix_neighbor_halo
EXEC_SHIFT_HALO = "exec_shift_halo"    # aggregation.mix_shift_halo
EXEC_CLUSTER = "exec_cluster"          # aggregation.mix_cluster
EXEC_GATHER = "exec_gather"            # aggregation.mix_gather (needs W)
EXEC_MEDIAN = "exec_median"            # aggregation.robust_median
EXEC_TRIMMED = "exec_trimmed"          # aggregation.robust_trimmed
EXEC_GEOMED = "exec_geomed"            # aggregation.robust_geomedian

# Auto sparse-mix crossover: reroute a GATHER mix through the segment mix
# only when the padded max degree is << C (degree * 8 <= C).
SEGMENT_DEGREE_FACTOR = 8

# Largest C for which a sparse topology may be densified to [C, C].
DENSIFY_MAX_CLIENTS = 4096


@dataclasses.dataclass(frozen=True)
class MixLowering:
    """How a topology's mix executes. ``offsets``/``weight`` are set for
    ``neighbor_permute``: client ``i`` adopts ``weight * sum_off
    model[(i + off) % C]``, accumulated in the fixed ``offsets`` order.
    ``offsets_table`` holds one offsets tuple per phase of a periodic
    schedule (:class:`GossipRotation`).

    >>> Ring(neighbors=1).lowering(8).offsets
    (-1, 0, 1)
    >>> FullMesh().lowering(8, fast_allreduce=True).kind
    'psum'
    >>> GossipRotation().lowering(4).offsets_table
    ((0, 1), (0, 2), (0, 3))
    """
    kind: str
    offsets: Tuple[int, ...] = ()
    weight: float = 0.0
    offsets_table: Tuple[Tuple[int, ...], ...] = ()


@dataclasses.dataclass(frozen=True, eq=False)
class MixPlan:
    """The resolved execution plan of one spec's Steps 2+5 mix, built only
    by :func:`resolve_mix_plan`. ``rounds.make_communicate`` switches on
    :attr:`mode` and ``rounds.dispatch_plan`` reports :attr:`mix` and
    :attr:`mode` verbatim, so report and execution cannot drift.
    ``weights`` / ``psum_row`` / ``sparse`` are host numpy payloads."""
    mode: str                   # EXEC_* executor strategy
    kind: str                   # MixLowering kind after reroutes
    # dispatch tier: "fused" | "segment" | "robust" | "jnp" (the plain,
    # non-kernel tier; the label is the JAX package's)
    mix: str
    offsets: Tuple[int, ...] = ()
    weight: float = 0.0
    offsets_table: Tuple[Tuple[int, ...], ...] = ()
    period: int = 1             # schedule period (1 for static topologies)
    n_shards: int = 1           # product of the mesh_axes extents
    fast_diagnostics: bool = False   # summed digest/divergence (tolerance)
    use_kernel: bool = False    # the mix_rows_flat kernel tier (fused_mix)
    needs_matrix: bool = False  # the executor reads the round's W
    n_clusters: int = 0         # EXEC_CLUSTER: G
    inter_weight: float = 0.0   # EXEC_CLUSTER: alpha
    trim: int = 0               # EXEC_TRIMMED: per-tail trim count
    robust_iters: int = 0       # EXEC_GEOMED: Weiszfeld iterations
    # eq=False (identity hash): a plan is never a cache key
    # repro-lint: disable=RL102
    weights: Optional[np.ndarray] = None    # |D_i| data weights [C]
    # repro-lint: disable=RL102
    psum_row: Optional[np.ndarray] = None   # EXEC_PSUM per-client weighting
    sparse: Optional["SparseLowering"] = None   # EXEC_SEGMENT edge lists


# Default Weiszfeld iteration count for robust_agg="geomed"
GEOMED_DEFAULT_ITERS = 8


def parse_robust(name: str, n_clients: int) -> Tuple[str, int, int]:
    """Parse a ``RoundSpec.robust_agg`` spec into ``(mode, trim, iters)``:
    ``median`` | ``trimmed[:t]`` (default 1; needs ``2t < C``) |
    ``geomed[:iters]`` (default 8).

    >>> parse_robust("trimmed:2", 8)
    ('exec_trimmed', 2, 0)
    >>> parse_robust("geomed", 8)
    ('exec_geomed', 0, 8)
    """
    head, _, arg = name.strip().lower().partition(":")
    if head == "median":
        return EXEC_MEDIAN, 0, 0
    if head in ("trimmed", "trim", "trimmed_mean"):
        t = int(arg) if arg else 1
        if not 0 <= 2 * t < n_clients:
            raise ValueError(
                f"robust_agg={name!r}: trim={t} must satisfy "
                f"2*trim < n_clients={n_clients}")
        return EXEC_TRIMMED, t, 0
    if head in ("geomed", "geomedian", "geometric_median"):
        iters = int(arg) if arg else GEOMED_DEFAULT_ITERS
        if iters < 1:
            raise ValueError(f"robust_agg={name!r}: needs >= 1 Weiszfeld "
                             "iteration")
        return EXEC_GEOMED, 0, iters
    raise ValueError(f"unknown robust_agg {name!r} (expected mean | median "
                     "| trimmed[:t] | geomed[:iters])")


def _resolve_robust(spec, c: int, n_shards: int) -> "MixPlan | None":
    """The ROBUST-kind plan when ``spec.robust_agg`` selects one, else None.
    The flags that only make sense for linear mixes are rejected."""
    robust = getattr(spec, "robust_agg", None)
    if robust in (None, "mean"):
        return None
    mode, trim, iters = parse_robust(robust, c)
    conflicts = [flag for flag, on in (
        ("fast_allreduce", _fast(spec)),
        ("fused_mix", spec.fused_mix),
        ("sparse_mix=True", spec.sparse_mix is True),
        ("data_weights", spec.data_weights is not None)) if on]
    if conflicts:
        raise ValueError(
            f"robust_agg={robust!r} is incompatible with "
            f"{', '.join(conflicts)}: robust reducers are order statistics "
            "over the full broadcast set — no psum/fused linear fast path, "
            "no sparse edge-list form, no |D_i| row reweighting")
    return MixPlan(mode=mode, kind=ROBUST, mix="robust", n_shards=n_shards,
                   trim=trim, robust_iters=iters)


def _fast(spec) -> bool:
    """``spec.fast_allreduce``, False for a duck-typed spec without it."""
    return bool(getattr(spec, "fast_allreduce", False))


def _resolve_sparse(spec, topo, kind) -> "SparseLowering | None":
    """The SparseLowering this spec mixes through, or None for dense mixes
    (``RoundSpec.sparse_mix``: None auto, True forced, False never)."""
    if spec.sparse_mix is False:
        return None
    if kind == SEGMENT:
        return topo.sparse_lowering(spec.n_clients)
    if spec.sparse_mix is True:
        sp = topo.sparse_lowering(spec.n_clients)
        if sp is None:
            raise ValueError(
                f"sparse_mix=True but {type(topo).__name__} exports no "
                "static sparse lowering (stochastic topologies and "
                "schedules change their graph per round; very large C "
                "cannot be densified to derive one)")
        return sp
    # auto: only GATHER-kind dense mixes, never preempting the opt-in tiers
    if kind != GATHER or _fast(spec) or spec.fused_mix:
        return None
    sp = topo.sparse_lowering(spec.n_clients)
    if sp is not None and \
            sp.max_degree * SEGMENT_DEGREE_FACTOR <= spec.n_clients:
        return sp
    return None


def resolve_mix_plan(spec, mesh_axes=None) -> MixPlan:
    """Resolve a round spec's mix into a :class:`MixPlan`: the single
    decision surface for how Steps 2+5 execute, on one device or on a
    client-sharded mesh.

    ``spec`` is duck-typed: the resolver reads ``topology``, ``n_clients``,
    ``data_weights``, ``fused_mix``, ``sparse_mix`` and, when present,
    ``fast_allreduce`` and ``robust_agg``. ``mesh_axes`` is None for one
    device, else ``((axis_name, extent), ...)`` of the client-sharded mesh
    (``launch.mesh.ClientMesh.axes``); only the extents' product, the
    shard count, feeds the decision.

    Decisions folded in: the |D_i| data-weight reroute (permute and cluster
    lowerings bake uniform weights, so a weighted spec mixes through its
    matrix); the sparse segment crossover; the ``fast_allreduce`` psum tier
    (uniform-row kinds to EXEC_PSUM with the pre-weighted row, dense ones to
    EXEC_PSUM_DENSE, both with summed diagnostics); halo feasibility (a
    neighbor window inside one shard's block runs the two-shift halo,
    EXEC_HALO, anything else the whole-block shift form, EXEC_SHIFT_HALO);
    and the robust override, which preempts them all.

    >>> from types import SimpleNamespace
    >>> def _spec(topo, **kw):
    ...     base = dict(topology=topo, n_clients=8, data_weights=None,
    ...                 fused_mix=False, sparse_mix=None)
    ...     return SimpleNamespace(**{**base, **kw})
    >>> resolve_mix_plan(_spec(FullMesh())).mode
    'exec_fedavg'
    >>> resolve_mix_plan(_spec(Ring(neighbors=1))).mode
    'exec_halo'
    >>> resolve_mix_plan(_spec(Ring(neighbors=2)),
    ...                  (("pod", 2), ("data", 4))).mode
    'exec_shift_halo'
    >>> resolve_mix_plan(_spec(FullMesh(), fast_allreduce=True)).mode
    'exec_psum'
    >>> resolve_mix_plan(_spec(RandomGraph(0.5), fused_mix=True)).mode
    'exec_gather'
    """
    topo = spec.topology
    c = spec.n_clients
    n_shards = 1
    for _, extent in (mesh_axes or ()):
        n_shards *= max(int(extent), 1)
    n_local = c // n_shards

    robust_plan = _resolve_robust(spec, c, n_shards)
    if robust_plan is not None:
        return robust_plan

    fast = _fast(spec)
    low = topo.lowering(c, fast_allreduce=fast)
    kind = low.kind

    weights = None
    if spec.data_weights is not None:
        if len(spec.data_weights) != c:
            raise ValueError(
                f"data_weights has {len(spec.data_weights)} entries, "
                f"expected n_clients={c}")
        weights = np.asarray(spec.data_weights, np.float32)

    # |D_i| weights reshape each row of W; the permute and cluster lowerings
    # hard-code uniform weights, so weighted mixes go through the matrix
    if weights is not None and kind in (NEIGHBOR_PERMUTE, CLUSTER):
        kind = GATHER

    sparse = _resolve_sparse(spec, topo, kind)
    if sparse is not None and weights is not None:
        sparse = sparse.reweighted(weights)

    # the psum tier covers the dense kinds only (permute lowerings already
    # move O(window) data and stay bitwise); a forced segment mix takes
    # precedence
    fast_dense = fast and sparse is None and kind in (PSUM, GATHER)

    psum_row = None
    if kind == PSUM:
        if topo.is_full_mesh:
            psum_row = weights
        else:
            row = np.asarray(topo.uniform_row(c), np.float32)
            psum_row = row if weights is None else row * weights

    period = topo.period(c) if isinstance(topo, Schedule) else 1

    if fast_dense:
        mode = EXEC_PSUM if kind == PSUM else EXEC_PSUM_DENSE
    elif sparse is not None:
        mode = EXEC_SEGMENT
    elif kind == ALL_REDUCE:
        mode = EXEC_FEDAVG
    elif kind == CLUSTER:
        mode = EXEC_CLUSTER
    elif kind == NEIGHBOR_PERMUTE and low.offsets_table:
        mode = EXEC_SHIFT_TABLE
    elif kind == NEIGHBOR_PERMUTE:
        # the two-shift halo needs the window inside one shard's block;
        # larger shifts take the whole-block shift form
        halo_ok = (low.offsets and -min(low.offsets) <= n_local
                   and max(low.offsets) <= n_local)
        mode = EXEC_HALO if halo_ok else EXEC_SHIFT_HALO
    else:
        mode = EXEC_GATHER

    n_clusters = int(getattr(topo, "n_clusters", 0)) if kind == CLUSTER \
        else 0
    inter_w = float(getattr(topo, "inter_weight", 0.0)) if kind == CLUSTER \
        else 0.0

    return MixPlan(
        mode=mode, kind=kind,
        mix=("fused" if spec.fused_mix
             else "segment" if sparse is not None else "jnp"),
        offsets=low.offsets, weight=low.weight,
        offsets_table=low.offsets_table, period=period, n_shards=n_shards,
        fast_diagnostics=fast_dense, use_kernel=spec.fused_mix,
        needs_matrix=mode in (EXEC_GATHER, EXEC_PSUM_DENSE),
        n_clusters=n_clusters, inter_weight=inter_w,
        weights=weights, psum_row=psum_row, sparse=sparse)


class SparseLowering:
    """Edge-list form of a mixing matrix: ``[C, D]`` neighbor indices and
    edge weights, padded to the max degree ``D`` with weight-0 self-edges.
    It represents ``W[i, neighbor_idx[i, d]] += edge_w[i, d]``.

    >>> sp = sparse_from_dense(Ring(neighbors=1).matrix(4))
    >>> sp.n_clients, sp.max_degree
    (4, 3)
    """

    __slots__ = ("neighbor_idx", "edge_w")

    def __init__(self, neighbor_idx, edge_w):
        idx = np.asarray(neighbor_idx, np.int32)
        w = np.asarray(edge_w, np.float32)
        if idx.ndim != 2 or idx.shape != w.shape:
            raise ValueError(
                f"neighbor_idx {idx.shape} and edge_w {w.shape} must be "
                "matching [n_clients, max_degree] arrays")
        if idx.shape[1] < 1:
            raise ValueError("SparseLowering needs max_degree >= 1")
        if idx.size and (idx.min() < 0 or idx.max() >= idx.shape[0]):
            raise ValueError(
                f"neighbor indices must lie in [0, {idx.shape[0]}), got "
                f"range [{idx.min()}, {idx.max()}]")
        self.neighbor_idx = idx
        self.edge_w = w

    @property
    def n_clients(self) -> int:
        return self.neighbor_idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbor_idx.shape[1]

    def to_dense(self, *,
                 max_clients: int = DENSIFY_MAX_CLIENTS) -> np.ndarray:
        """The represented dense ``[C, C]`` matrix (small C only)."""
        c = self.n_clients
        if c > max_clients:
            raise ValueError(
                f"refusing to densify a SparseLowering with n_clients={c} > "
                f"{max_clients}: the [C, C] matrix is what the sparse path "
                "exists to avoid (raise max_clients explicitly if you truly "
                "want it)")
        w = np.zeros((c, c), np.float32)
        rows = np.repeat(np.arange(c), self.max_degree)
        np.add.at(w, (rows, self.neighbor_idx.reshape(-1)),
                  self.edge_w.reshape(-1))
        return w

    def reweighted(self, weights) -> "SparseLowering":
        """|D_j| reweighting: ``w'[i, d] ∝ w[i, d] *
        weights[neighbor_idx[i, d]]``, renormalized per row."""
        wvec = np.asarray(weights, np.float32)
        if wvec.shape != (self.n_clients,):
            raise ValueError(
                f"weights shape {wvec.shape} != ({self.n_clients},)")
        w = self.edge_w * wvec[self.neighbor_idx]
        return SparseLowering(self.neighbor_idx,
                              w / w.sum(axis=1, keepdims=True))


def sparse_from_dense(w, *, min_degree: int = 1) -> SparseLowering:
    """Edge-list form of a dense mixing matrix: each row keeps its nonzero
    entries in ascending column order, padded to the max row degree with
    weight-0 self-edges.

    >>> [int(i) for i in sparse_from_dense(np.eye(3)).neighbor_idx.ravel()]
    [0, 1, 2]
    """
    w = np.asarray(w, np.float32)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"expected a square [C, C] matrix, got {w.shape}")
    c = w.shape[0]
    nz = [np.flatnonzero(w[i]) for i in range(c)]
    d = max(max((len(r) for r in nz), default=0), min_degree, 1)
    idx = np.tile(np.arange(c, dtype=np.int32)[:, None], (1, d))
    ew = np.zeros((c, d), np.float32)
    for i, cols in enumerate(nz):
        idx[i, :len(cols)] = cols
        ew[i, :len(cols)] = w[i, cols]
    return SparseLowering(idx, ew)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Base topology. :meth:`matrix` returns a float32 row-stochastic
    ``[C, C]`` numpy array: ``W[i, j] >= 0`` is the weight client i puts on
    client j's broadcast model. ``generator`` (a CPU ``torch.Generator``)
    is only consulted when :attr:`stochastic` is True; ``round_idx``
    selects the phase of a :class:`Schedule`."""

    @property
    def is_full_mesh(self) -> bool:
        return False

    @property
    def stochastic(self) -> bool:
        """True when the mixing matrix needs per-round randomness."""
        return False

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        raise NotImplementedError

    def uniform_row(self, n_clients: int) -> Optional[np.ndarray]:
        """The shared row ``r`` when every round's ``W`` has identical rows
        (``W = 1 r^T``), else None. Such a mix is rank-1, every client
        adopts the same r-weighted average, so under ``fast_allreduce`` it
        runs as a sum of locally pre-weighted rows. Deterministic
        topologies only."""
        if self.stochastic:
            return None
        try:
            if isinstance(self, Schedule):
                mats = [self.matrix_at(t, n_clients)
                        for t in range(self.period(n_clients))]
            else:
                mats = [self.matrix(n_clients)]
        except NotImplementedError:
            return None
        row = mats[0][0]
        for m in mats:
            if not (m == row[None, :]).all():
                return None
        return row

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        """Default: the dense gather, correct for any row-stochastic W;
        under ``fast_allreduce`` a uniform-row topology's :data:`PSUM`."""
        if fast_allreduce and self.uniform_row(n_clients) is not None:
            return MixLowering(kind=PSUM)
        return MixLowering(kind=GATHER)

    def sparse_lowering(self, n_clients: int) -> "SparseLowering | None":
        """Edge-list export of this topology's mix, or None when no static
        sparse form exists (stochastic draws, schedules, very large C)."""
        if self.stochastic or isinstance(self, Schedule):
            return None
        if n_clients > DENSIFY_MAX_CLIENTS:
            return None
        try:
            w = self.matrix(n_clients)
        except NotImplementedError:
            return None
        return sparse_from_dense(w)


@dataclasses.dataclass(frozen=True)
class FullMesh(Topology):
    """Paper baseline: every broadcast reaches everyone, ``W = 11^T / C``.

    >>> bool((FullMesh().matrix(4) == 0.25).all())
    True
    """

    @property
    def is_full_mesh(self) -> bool:
        return True

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        return np.full((n_clients, n_clients), 1.0 / n_clients, np.float32)

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        """The client mean (``fedavg``); under ``fast_allreduce`` a sum
        over the ranks (:data:`PSUM`)."""
        if fast_allreduce:
            return MixLowering(kind=PSUM)
        return MixLowering(kind=ALL_REDUCE)


@dataclasses.dataclass(frozen=True)
class Ring(Topology):
    """Static ring gossip: each client averages itself with ``neighbors``
    clients on each side, uniformly over the distinct window members."""
    neighbors: int = 1

    def __post_init__(self):
        if self.neighbors < 1:
            raise ValueError("Ring needs neighbors >= 1")

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        w = np.zeros((n_clients, n_clients), np.float32)
        span = range(-self.neighbors, self.neighbors + 1)
        for i in range(n_clients):
            for off in span:
                w[i, (i + off) % n_clients] = 1.0
        return w / w.sum(axis=1, keepdims=True)

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        """Shifts of the window when it is distinct (``2k + 1 <= C``), else
        the dense matrix (the window wraps onto itself). ``fast_allreduce``
        changes nothing: the halo moves O(window) and stays bitwise."""
        window = 2 * self.neighbors + 1
        if window > n_clients:
            return MixLowering(kind=GATHER)
        offsets = tuple(range(-self.neighbors, self.neighbors + 1))
        return MixLowering(kind=NEIGHBOR_PERMUTE, offsets=offsets,
                           weight=1.0 / window)


@dataclasses.dataclass(frozen=True)
class RandomGraph(Topology):
    """Per-round i.i.d. link dropout: each directed link (i, j != i)
    delivers with probability ``p_link``; the self-link always does. Rows
    renormalize over the delivered set. Draws come from the CPU generator
    (the JAX package's ``bernoulli`` stream cannot be reproduced; tests
    inject its matrices)."""
    p_link: float = 0.8

    def __post_init__(self):
        if not 0.0 <= self.p_link <= 1.0:
            raise ValueError("p_link must be in [0, 1]")

    @property
    def stochastic(self) -> bool:
        return True

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        if generator is None:
            raise ValueError("RandomGraph.matrix needs a torch.Generator")
        u = torch.rand((n_clients, n_clients), generator=generator,
                       dtype=torch.float32).numpy()
        links = (u < self.p_link).astype(np.float32)
        adj = np.maximum(links, np.eye(n_clients, dtype=np.float32))
        return adj / adj.sum(axis=1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class PartialParticipation(Topology):
    """Only the first ``n_active`` clients take part (they adopt the active
    average); the others keep their own models."""
    n_active: int

    def __post_init__(self):
        if self.n_active < 1:
            raise ValueError("PartialParticipation needs n_active >= 1")

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        if self.n_active > n_clients:
            raise ValueError(
                f"n_active={self.n_active} exceeds n_clients={n_clients}")
        w = np.eye(n_clients, dtype=np.float32)
        w[:self.n_active, :] = 0.0
        w[:self.n_active, :self.n_active] = 1.0 / self.n_active
        return w

    def sparse_lowering(self, n_clients: int) -> "SparseLowering | None":
        """Edges built directly in O(C * n_active)."""
        if self.n_active > n_clients:
            raise ValueError(
                f"n_active={self.n_active} exceeds n_clients={n_clients}")
        a, c = self.n_active, n_clients
        idx = np.tile(np.arange(c, dtype=np.int32)[:, None], (1, a))
        ew = np.zeros((c, a), np.float32)
        idx[:a] = np.arange(a, dtype=np.int32)[None, :]
        ew[:a] = 1.0 / a
        ew[a:, 0] = 1.0
        return SparseLowering(idx, ew)

    def uniform_row(self, n_clients: int) -> Optional[np.ndarray]:
        """Never rank-1 below full participation (and never densified to
        find out); ``n_active == n_clients`` is the full mesh's row."""
        if self.n_active == n_clients:
            return np.full((n_clients,), 1.0 / n_clients, np.float32)
        return None


@dataclasses.dataclass(frozen=True)
class PairShift(Topology):
    """Client ``i`` averages itself with client ``(i + shift) % C``, each at
    weight 1/2.

    >>> [float(v) for v in PairShift(shift=1).matrix(4)[0]]
    [0.5, 0.5, 0.0, 0.0]
    """
    shift: int = 1

    def __post_init__(self):
        if self.shift < 0:
            raise ValueError("PairShift needs shift >= 0")

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        w = np.zeros((n_clients, n_clients), np.float32)
        for i in range(n_clients):
            w[i, i] += 0.5
            w[i, (i + self.shift) % n_clients] += 0.5
        return w

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        return MixLowering(kind=NEIGHBOR_PERMUTE,
                           offsets=(0, self.shift % n_clients), weight=0.5)


@dataclasses.dataclass(frozen=True)
class ClusterTopology(Topology):
    """Two-level mix: ``G = n_clusters`` contiguous clusters of ``S = C/G``
    clients; every client adopts its cluster mean, then cluster ``g`` keeps
    ``1 - inter_weight`` of its own mean and takes ``inter_weight / 2`` of
    each ring neighbor's: ``W = B ⊗ (J_S / S)``.

    >>> ClusterTopology(n_clusters=4).lowering(8).kind
    'cluster'
    """
    n_clusters: int
    inter_weight: float = 0.3

    def __post_init__(self):
        if self.n_clusters < 1:
            raise ValueError("ClusterTopology needs n_clusters >= 1")
        if not 0.0 <= self.inter_weight <= 1.0:
            raise ValueError("inter_weight must be in [0, 1]")

    def _check_divides(self, n_clients: int) -> int:
        if n_clients % self.n_clusters != 0:
            raise ValueError(
                f"n_clients={n_clients} not divisible by "
                f"n_clusters={self.n_clusters}: clusters are contiguous "
                "equal-size client blocks")
        return n_clients // self.n_clusters

    def _cluster_ring(self) -> np.ndarray:
        """The ``[G, G]`` circulant ``B`` over cluster means."""
        g = self.n_clusters
        b = np.zeros((g, g), np.float32)
        for i in range(g):
            b[i, i] += 1.0 - self.inter_weight
            b[i, (i - 1) % g] += self.inter_weight / 2.0
            b[i, (i + 1) % g] += self.inter_weight / 2.0
        return b

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        s = self._check_divides(n_clients)
        w = np.kron(self._cluster_ring(),
                    np.full((s, s), 1.0 / s, np.float32))
        return w.astype(np.float32)

    def uniform_row(self, n_clients: int) -> Optional[np.ndarray]:
        """Constant-row exactly when the cluster circulant ``B`` is,
        checked on the ``[G, G]`` block, never on the dense ``W``."""
        s = self._check_divides(n_clients)
        b = self._cluster_ring()
        if not (b == b[0][None, :]).all():
            return None
        return np.repeat(b[0], s).astype(np.float32) / np.float32(s)

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        """Always the :data:`CLUSTER` kind: the two-level mix moves O(S + 2)
        models and stays bitwise, so ``fast_allreduce`` changes nothing."""
        self._check_divides(n_clients)
        return MixLowering(kind=CLUSTER, weight=self.inter_weight)


@dataclasses.dataclass(frozen=True)
class ExplicitSparse(Topology):
    """A topology given as per-client neighbor lists (the SEGMENT kind).
    ``weights[i]`` are the row weights of ``neighbors[i]`` (default
    uniform); rows are normalized at lowering time.

    >>> t = ExplicitSparse(neighbors=((0, 1), (0, 1, 2), (1, 2)))
    >>> t.lowering(3).kind
    'segment'
    """
    neighbors: Tuple[Tuple[int, ...], ...]
    weights: Optional[Tuple[Tuple[float, ...], ...]] = None

    def __post_init__(self):
        if not self.neighbors:
            raise ValueError("ExplicitSparse needs at least one client row")
        c = len(self.neighbors)
        for i, row in enumerate(self.neighbors):
            if not row:
                raise ValueError(f"client {i} has an empty neighbor list; "
                                 "give it at least a self-edge (i,)")
            for j in row:
                if not 0 <= j < c:
                    raise ValueError(
                        f"client {i} lists neighbor {j} outside [0, {c})")
        if self.weights is not None:
            if len(self.weights) != c:
                raise ValueError(
                    f"weights has {len(self.weights)} rows, expected {c}")
            for i, (row, wrow) in enumerate(zip(self.neighbors, self.weights)):
                if len(wrow) != len(row):
                    raise ValueError(
                        f"client {i}: {len(wrow)} weights for "
                        f"{len(row)} neighbors")
                if any(w < 0 for w in wrow) or sum(wrow) <= 0:
                    raise ValueError(
                        f"client {i}: row weights must be nonnegative with "
                        "a positive sum")

    @classmethod
    def from_lowering(cls, sparse: SparseLowering) -> "ExplicitSparse":
        """Wrap a :class:`SparseLowering` back into a hashable topology
        (drops weight-0 padding edges)."""
        neighbors, weights = [], []
        for i in range(sparse.n_clients):
            keep = np.flatnonzero(sparse.edge_w[i])
            if keep.size == 0:
                neighbors.append((i,))
                weights.append((1.0,))
                continue
            neighbors.append(tuple(int(j) for j in sparse.neighbor_idx[i, keep]))
            weights.append(tuple(float(w) for w in sparse.edge_w[i, keep]))
        return cls(neighbors=tuple(neighbors), weights=tuple(weights))

    def sparse_lowering(self, n_clients: int) -> SparseLowering:
        if n_clients != len(self.neighbors):
            raise ValueError(
                f"ExplicitSparse defines {len(self.neighbors)} clients but "
                f"the spec asks for n_clients={n_clients}")
        c = n_clients
        d = max(len(row) for row in self.neighbors)
        idx = np.tile(np.arange(c, dtype=np.int32)[:, None], (1, d))
        ew = np.zeros((c, d), np.float32)
        for i, row in enumerate(self.neighbors):
            idx[i, :len(row)] = row
            wrow = (np.ones(len(row), np.float32) if self.weights is None
                    else np.asarray(self.weights[i], np.float32))
            ew[i, :len(row)] = wrow / wrow.sum()
        return SparseLowering(idx, ew)

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        """Dense form for small-C diagnostics only."""
        return self.sparse_lowering(n_clients).to_dense()

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        return MixLowering(kind=SEGMENT)


def ring_neighbors(n_clients: int, neighbors: int = 1
                   ) -> Tuple[Tuple[int, ...], ...]:
    """Neighbor lists of the :class:`Ring` window (ascending, distinct),
    for an :class:`ExplicitSparse` ring.

    >>> ring_neighbors(5, 1)[0]
    (0, 1, 4)
    """
    if neighbors < 1:
        raise ValueError("ring_neighbors needs neighbors >= 1")
    span = range(-neighbors, neighbors + 1)
    return tuple(
        tuple(sorted({(i + off) % n_clients for off in span}))
        for i in range(n_clients))


# ---------------------------------------------------------------------------
# Schedules: round-indexed (time-varying) topologies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule(Topology):
    """A periodic, round-indexed sequence of mixing matrices: round ``t``
    uses phase ``t % P``, ``P = period(C)``. Subclasses define
    :meth:`period` and :meth:`topology_at` (or :meth:`matrix_at`)."""

    def period(self, n_clients: int) -> int:
        raise NotImplementedError

    def topology_at(self, t: int, n_clients: int) -> Topology:
        raise NotImplementedError

    def matrix_at(self, t: int, n_clients: int, *,
                  generator=None) -> np.ndarray:
        """Mixing matrix of phase ``t``."""
        return self.topology_at(t, n_clients).matrix(
            n_clients, generator=generator, round_idx=t)

    def table(self, n_clients: int) -> np.ndarray:
        """The ``[P, C, C]`` phase table of a deterministic schedule."""
        return np.stack([self.matrix_at(t, n_clients)
                         for t in range(self.period(n_clients))])

    def matrix(self, n_clients: int, *, generator=None,
               round_idx=None) -> np.ndarray:
        t = (0 if round_idx is None else int(round_idx)) \
            % self.period(n_clients)
        if not self.stochastic:
            return self.table(n_clients)[t]
        if generator is None:
            raise ValueError("a stochastic Schedule needs a torch.Generator")
        return self.matrix_at(t, n_clients, generator=generator)


@dataclasses.dataclass(frozen=True)
class GossipRotation(Schedule):
    """One-peer gossip rotation: at round ``t`` every client pair-averages
    with the partner at shift ``1 + (t * step) % (C - 1)``.

    >>> [GossipRotation().shift_at(t, 5) for t in range(4)]
    [1, 2, 3, 4]
    """
    step: int = 1

    def __post_init__(self):
        if self.step < 1:
            raise ValueError("GossipRotation needs step >= 1")

    def period(self, n_clients: int) -> int:
        return max(n_clients - 1, 1)

    def shift_at(self, t: int, n_clients: int) -> int:
        if n_clients <= 1:
            return 0
        return 1 + (t * self.step) % (n_clients - 1)

    def topology_at(self, t: int, n_clients: int) -> Topology:
        return PairShift(shift=self.shift_at(t, n_clients))

    def lowering(self, n_clients: int, *,
                 fast_allreduce: bool = False) -> MixLowering:
        table = tuple((0, self.shift_at(t, n_clients))
                      for t in range(self.period(n_clients)))
        return MixLowering(kind=NEIGHBOR_PERMUTE, weight=0.5,
                           offsets_table=table)


@dataclasses.dataclass(frozen=True)
class AlternatingSchedule(Schedule):
    """Cycle through ``phases``, each a ``(topology, n_rounds)`` pair, e.g.
    ring gossip for k rounds then one full-mesh round.

    >>> s = AlternatingSchedule(((Ring(neighbors=1), 2), (FullMesh(), 1)))
    >>> [type(s.topology_at(t, 8)).__name__ for t in range(3)]
    ['Ring', 'Ring', 'FullMesh']
    """
    phases: Tuple[Tuple[Topology, int], ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("AlternatingSchedule needs at least one phase")
        for topo, n in self.phases:
            if not isinstance(topo, Topology):
                raise ValueError(f"phase topology {topo!r} is not a Topology")
            if n < 1:
                raise ValueError("phase lengths must be >= 1")

    @property
    def stochastic(self) -> bool:
        return any(t.stochastic for t, _ in self.phases)

    def period(self, n_clients: int) -> int:
        return sum(n for _, n in self.phases)

    def topology_at(self, t: int, n_clients: int) -> Topology:
        t %= self.period(n_clients)
        for topo, n in self.phases:
            if t < n:
                return topo
            t -= n
        raise RuntimeError("unreachable: t < period by construction")


@dataclasses.dataclass(frozen=True)
class LinkQualitySchedule(Schedule):
    """SNR-derived link-quality mixing with periodic fading on the client
    ring: link (i, j) sees ``snr_db - pathloss_db * (ring_distance - 1)``
    plus a per-edge periodic fading term, weighted by ``q = snr / (1 +
    snr)``; self links are perfect and rows renormalize.

    >>> w = LinkQualitySchedule(fading_period=4).matrix_at(0, 6)
    >>> bool(np.allclose(w.sum(axis=1), 1.0)) and bool((w > 0).all())
    True
    """
    snr_db: float = 8.0
    pathloss_db: float = 3.0
    fading_db: float = 6.0
    fading_period: int = 8

    def __post_init__(self):
        if self.fading_period < 1:
            raise ValueError("LinkQualitySchedule needs fading_period >= 1")

    def period(self, n_clients: int) -> int:
        return self.fading_period

    def matrix_at(self, t: int, n_clients: int, *,
                  generator=None) -> np.ndarray:
        i = np.arange(n_clients)[:, None]
        j = np.arange(n_clients)[None, :]
        dist = np.minimum(np.abs(i - j), n_clients - np.abs(i - j))
        fade = 0.5 * self.fading_db * np.cos(
            2.0 * np.pi * (t / self.fading_period + (i + j) / n_clients))
        snr_lin = 10.0 ** ((self.snr_db - self.pathloss_db * (dist - 1) + fade)
                           / 10.0)
        q = snr_lin / (1.0 + snr_lin)
        np.fill_diagonal(q, 1.0)
        return (q / q.sum(axis=1, keepdims=True)).astype(np.float32)


# Salt of a run's topology stream (the JAX package's fold_in salt): a
# stochastic topology draws from a CPU generator of its own, so adding one
# never moves the run's lazy, DP and attack draws.
_TOPOLOGY_SALT = 0x746F706F  # "topo"


def salted_generator(seed: int, salt: int) -> torch.Generator:
    """A CPU generator of its own for the stream ``salt`` of run ``seed``.
    The two are hashed into the 32-bit seed that the CPU generator keeps
    (it drops the upper half of a 64-bit seed), so every run seed gives
    another stream.

    >>> a, b = salted_generator(0, 1), salted_generator(1, 1)
    >>> bool(torch.equal(torch.rand(2, generator=a),
    ...                  torch.rand(2, generator=b)))
    False
    """
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, int(salt)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def topology_generator(seed: int) -> torch.Generator:
    """The CPU generator of a run's stochastic topology draws, seeded from
    the run seed and :data:`_TOPOLOGY_SALT`."""
    return salted_generator(seed, _TOPOLOGY_SALT)


def round_table(topo: Topology, n_clients: int, n_rounds: int,
                generator: Optional[torch.Generator] = None) -> np.ndarray:
    """The ``[M, C, C]`` float32 matrices of a run: round ``k`` mixes with
    ``table[k % M]``. A deterministic topology gives its phase table (M =
    P for a schedule, 1 for a static topology) and ignores ``generator``;
    a stochastic one draws ``n_rounds`` matrices from ``generator`` (the
    run's :func:`topology_generator`), round ``k``'s at ``k``.

    >>> round_table(Ring(neighbors=1), 4, 3).shape
    (1, 4, 4)
    """
    if topo.stochastic:
        if generator is None:
            raise ValueError(f"{type(topo).__name__} is stochastic: pass "
                             "the run's topology generator")
        return np.stack([topo.matrix(n_clients, generator=generator,
                                     round_idx=k)
                         for k in range(int(n_rounds))])
    if isinstance(topo, Schedule):
        return topo.table(n_clients)
    return topo.matrix(n_clients)[None]


# Salt of a run's cohort stream (the JAX package's fold_in salt): the
# memberships draw from a CPU generator of their own, so a stochastic
# intra-cohort topology draws the same matrices with a cohort as without.
_COHORT_SALT = 0x636F686F  # "coho"


@dataclasses.dataclass(frozen=True)
class CohortSchedule:
    """Per-round active-cohort sampling from an enrolled population (the
    JAX package's ``CohortSchedule``).

    Each round, :meth:`cohort_at` draws ``cohort_size`` distinct clients of
    the ``n_enrolled`` population. ``bias`` shapes the selection weights:
    ``uniform`` (every client equally likely), ``pareto`` (client ``i``
    drawn in proportion to ``(i + 1) ** -pareto_alpha``: a head of clients
    in nearly every round, a tail that rarely joins) or ``prefix`` (the
    first ``cohort_size`` clients, deterministically). Sampling without
    replacement is the Gumbel top-k trick over ``log w``; the cohort comes
    back sorted ascending, so the intra-round client order is a function of
    the membership set alone.

    >>> cs = CohortSchedule(n_enrolled=100, cohort_size=8)
    >>> idx = cs.cohort_at(torch.Generator().manual_seed(0))
    >>> int(idx.shape[0]), bool((idx[1:] > idx[:-1]).all())
    (8, True)
    >>> CohortSchedule(10, 3, bias="prefix").cohort_at(None)
    array([0, 1, 2], dtype=int32)
    """
    n_enrolled: int
    cohort_size: int
    bias: str = "uniform"
    pareto_alpha: float = 1.1

    def __post_init__(self):
        if self.n_enrolled < 1:
            raise ValueError("CohortSchedule needs n_enrolled >= 1")
        if not 1 <= self.cohort_size <= self.n_enrolled:
            raise ValueError(
                f"cohort_size={self.cohort_size} must lie in "
                f"[1, n_enrolled={self.n_enrolled}]")
        if self.bias not in ("uniform", "pareto", "prefix"):
            raise ValueError(
                f"unknown bias {self.bias!r} "
                "(expected uniform | pareto | prefix)")
        if self.bias == "pareto" and self.pareto_alpha <= 0:
            raise ValueError("pareto bias needs pareto_alpha > 0")

    @classmethod
    def from_spec(cls, n_enrolled: int, cohort_size: int,
                  bias_spec: str = "uniform") -> "CohortSchedule":
        """CLI constructor: ``bias_spec`` is ``uniform | pareto[:alpha] |
        prefix`` (``--cohort-bias``).

        >>> CohortSchedule.from_spec(100, 8, "pareto:1.5").pareto_alpha
        1.5
        """
        head, _, arg = bias_spec.strip().lower().partition(":")
        if head == "pareto" and arg:
            return cls(n_enrolled, cohort_size, bias="pareto",
                       pareto_alpha=float(arg))
        return cls(n_enrolled, cohort_size, bias=head)

    def weights(self) -> np.ndarray:
        """The normalized float64 selection weights ``[n_enrolled]``."""
        if self.bias == "pareto":
            w = (np.arange(self.n_enrolled, dtype=np.float64) + 1.0) \
                ** -self.pareto_alpha
        elif self.bias == "prefix":
            w = np.zeros(self.n_enrolled, np.float64)
            w[:self.cohort_size] = 1.0
        else:
            w = np.ones(self.n_enrolled, np.float64)
        return w / w.sum()

    def cohort_at(self, generator: Optional[torch.Generator]) -> np.ndarray:
        """One round's cohort: ``[cohort_size]`` distinct int32 client ids in
        ascending order, drawn on the CPU from ``generator`` (unused by
        ``prefix``): the top ``cohort_size`` of Gumbel noise plus ``log
        w``."""
        if self.bias == "prefix":
            return np.arange(self.cohort_size, dtype=np.int32)
        # Gumbel(0, 1) = -log(Exp(1))
        gumbel = -torch.empty(self.n_enrolled, dtype=torch.float32) \
            .exponential_(generator=generator).log()
        if self.bias == "pareto":
            gumbel -= float(np.float32(self.pareto_alpha)) * torch.log1p(
                torch.arange(self.n_enrolled, dtype=torch.float32))
        idx = torch.topk(gumbel, self.cohort_size).indices
        return np.sort(idx.numpy()).astype(np.int32)


def cohort_generator(seed: int) -> torch.Generator:
    """The CPU generator of a run's cohort draws, seeded from the run seed
    and :data:`_COHORT_SALT`."""
    return salted_generator(seed, _COHORT_SALT)


def cohort_table(schedule: CohortSchedule, n_rounds: int,
                 seed: int) -> np.ndarray:
    """A run's memberships, ``[n_rounds, cohort_size]`` int32, drawn up
    front round by round from :func:`cohort_generator` of ``seed``: the same
    seed replays the same cohorts.

    >>> cs = CohortSchedule(50, 4)
    >>> bool((cohort_table(cs, 3, 7) == cohort_table(cs, 3, 7)).all())
    True
    """
    gen = cohort_generator(seed)
    return np.stack([schedule.cohort_at(gen) for _ in range(int(n_rounds))])


def from_name(name: str) -> Topology:
    """Parse a CLI topology / schedule spec: ``full`` | ``ring[:k]`` |
    ``random[:p_link]`` | ``partial:n_active`` | ``shift[:s]`` |
    ``cluster:g[:alpha]`` | ``rotate[:step]`` | ``alt[:k[:m]]`` |
    ``snr[:fading_period]``.

    >>> from_name("rotate") == GossipRotation()
    True
    >>> from_name("cluster:4:0.5")
    ClusterTopology(n_clusters=4, inter_weight=0.5)
    """
    head, _, arg = name.strip().lower().partition(":")
    if head in ("full", "full_mesh", "fullmesh", "mesh"):
        return FullMesh()
    if head == "ring":
        return Ring(neighbors=int(arg) if arg else 1)
    if head in ("random", "dropout", "p"):
        return RandomGraph(p_link=float(arg) if arg else 0.8)
    if head == "partial":
        if not arg:
            raise ValueError("partial topology needs a size: partial:<n_active>")
        return PartialParticipation(n_active=int(arg))
    if head in ("shift", "pair"):
        return PairShift(shift=int(arg) if arg else 1)
    if head in ("rotate", "rotation", "gossip"):
        return GossipRotation(step=int(arg) if arg else 1)
    if head in ("alt", "alternate", "alternating"):
        ring_rounds, _, mesh_rounds = arg.partition(":")
        return AlternatingSchedule((
            (Ring(neighbors=1), int(ring_rounds) if ring_rounds else 3),
            (FullMesh(), int(mesh_rounds) if mesh_rounds else 1)))
    if head in ("snr", "linkquality", "link_quality"):
        return LinkQualitySchedule(
            fading_period=int(arg) if arg else 8)
    if head in ("cluster", "clusters", "hier", "hierarchical"):
        if not arg:
            raise ValueError(
                "cluster topology needs a size: cluster:<n_clusters>[:alpha]")
        g, _, alpha = arg.partition(":")
        return ClusterTopology(n_clusters=int(g),
                               inter_weight=float(alpha) if alpha else 0.3)
    raise ValueError(f"unknown topology {name!r} "
                     "(expected full | ring[:k] | random[:p] | partial:n | "
                     "shift[:s] | cluster:g[:a] | rotate[:step] | "
                     "alt[:k[:m]] | snr[:p])")
