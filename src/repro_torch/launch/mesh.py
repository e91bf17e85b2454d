"""Client meshes over ``torch.distributed``, and the spawner of their ranks.

The JAX package runs the client-sharded engine as one program over a mesh
of devices (``jax.sharding.Mesh`` and ``shard_map``). torch's model is one
process a rank: :func:`run_world` spawns the ranks, each joins one process
group, and inside a rank :func:`make_client_mesh` (the 1-D ``("data",)``
mesh) or :func:`make_cluster_mesh` (the 2-D ``("pod", "data")`` mesh, one
pod row a cluster) builds the :class:`ClientMesh` the round engine takes
(``core/rounds.py``'s ``mesh=``). Ranks are laid out row-major over the
axes, so a rank's linear shard index is its rank, and an all-gather over
the world concatenates the client blocks in client order.

:class:`ClientMesh` holds the collectives the engine uses, each on a
tensor of the rank's device:

  ``all_gather``  blocks of every rank of an axis, of a tuple of axes
                  (row-major over their coordinates, the block order of a
                  ``NamedSharding``) or of the world, concatenated along
                  any dim
  ``all_reduce``  the sum over an axis, a tuple of axes or the world
  ``shift``       for each ``q``, the block of the rank ``q`` places
                  ahead along an axis (or the linear world), as one batch
                  of sends and receives
  ``reduce_scatter``  this rank's block of the sum over an axis or a
                  tuple of axes, along any dim: a ring of shifts, so that
                  a rank receives ``(n - 1) / n`` of the tensor as NCCL's
                  reduce-scatter would (gloo has none)

NCCL refuses two ranks on one card, so on one GPU the ranks run over gloo,
which moves CUDA tensors through host memory. An op that gloo does not take
on CUDA tensors is staged through pinned host buffers here, by name
(:data:`GLOO_CUDA_STAGED`), and :attr:`ClientMesh.transport` reports each
op's transport; the arithmetic stays on the card. gloo ranks sharing one
card measure no multi-GPU communication.

The JAX package's ``make_production_mesh`` has its counterpart in
``launch.dryrun.DryMesh``: one rank of a mesh of any extents with no
process group, whose collectives give outputs of their shapes and count
their bytes as a rank's do; the H100's constants are in
``launch/analysis.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import pickle
import queue
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import cost_analysis

BACKENDS = ("gloo", "nccl")

# a collective's axes: None (the world), a name, or a tuple of names
Axes = Union[None, str, Tuple[str, ...]]

# ops whose CUDA tensors gloo does not move: they go through pinned host
# buffers (the point-to-point sends and receives of ``shift``, and of the
# ring ``reduce_scatter`` runs)
GLOO_CUDA_STAGED = frozenset({"shift", "reduce_scatter"})

# seconds a rank waits in one collective, and run_world for its ranks
DEFAULT_TIMEOUT_S = 600.0
# seconds the other ranks get to finish once one has failed
FAILURE_GRACE_S = 10.0


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """One rank's view of a client mesh.

    ``axis_names`` ``("data",)`` or ``("pod", "data")`` with extents
    ``shape``; ``rank`` is this process's world rank (its linear shard
    index); ``groups`` holds this rank's process group along each axis
    (the ranks that differ from it in that coordinate only), ``world`` the
    group of every rank, and a group of each line along every other set
    of axes under their tuple in mesh order (``("data", "model")`` on a
    three-axis mesh). ``received_by_axes`` counts the analytic bytes each
    op received on this rank (an all-gather the other ranks' blocks, an
    all-reduce a ring's ``2 (n - 1) / n`` of its tensor, a shift the block
    it took, a reduce-scatter the ``n - 1`` blocks its ring passed on)
    under ``"<op> over <axes>"`` (the axes joined by ``+``), for the
    communication a round or a step moves and the line that carried it;
    ``received`` is the same bytes by op alone.

    :meth:`view` gives the mesh of a subset of the axes (a line of ranks,
    such as the data axis of a ``("data", "model")`` mesh): its ranks
    are the ranks of this rank's line, ``rank`` is this rank's index on
    it, ``world_ranks`` maps the view's ranks to the world's, and it
    shares the groups and the counter of the mesh it was cut from.

    At one rank the all-gather and the all-reduce still call the backend
    (so an NCCL rank's graph driver captures them); a shift onto this rank
    returns the block itself (NCCL hangs on a send to its own rank)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    backend: str
    device: torch.device
    world: Any
    groups: Dict[str, Any]
    received_by_axes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # the world rank of each of this mesh's ranks (() : the same)
    world_ranks: Tuple[int, ...] = ()

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.shape))

    @property
    def shard_index(self) -> int:
        """Linear index of this rank's client block (row-major over the
        axes: its rank)."""
        return self.rank

    @property
    def axes(self) -> Tuple[Tuple[str, int], ...]:
        """``((name, extent), ...)``: the ``mesh_axes`` of
        ``topology.resolve_mix_plan``."""
        return tuple(zip(self.axis_names, self.shape))

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(axis)])

    def staged(self, op: str) -> bool:
        """Whether ``op`` goes through pinned host buffers on this mesh."""
        return (self.backend == "gloo" and self.device.type == "cuda"
                and op in GLOO_CUDA_STAGED)

    @property
    def transport(self) -> Dict[str, str]:
        """Each op's transport on this mesh, for the record."""
        direct = f"{self.backend} on {self.device.type} tensors"
        return {op: ("pinned host buffers over gloo" if self.staged(op)
                     else direct)
                for op in ("all_gather", "all_reduce", "shift",
                           "reduce_scatter")}

    @property
    def received(self) -> Dict[str, int]:
        """``received_by_axes`` summed by op (a new dict: clear the
        counts through ``received_by_axes``)."""
        out: Dict[str, int] = {}
        for key, n in self.received_by_axes.items():
            op = key.split(" over ")[0]
            out[op] = out.get(op, 0) + n
        return out

    def _count(self, op: str, nbytes: float, axes: Tuple[str, ...]
               ) -> None:
        """Count ``nbytes`` received by ``op`` over ``axes``, here and in
        the active ``cost_analysis`` counters."""
        key = f"{op} over {'+'.join(axes)}"
        self.received_by_axes[key] = self.received_by_axes.get(key, 0) \
            + int(nbytes)
        cost_analysis.report_collective(key, nbytes)

    def view(self, axes: Axes) -> "ClientMesh":
        """The mesh of ``axes`` (a name or a tuple of names; kept in this
        mesh's order) through this rank: the ranks that share this rank's
        coordinates on every other axis. It makes no process group (it
        takes this mesh's), so a rank may cut it at any time."""
        axes = self._axes(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes == self.axis_names:
            return self
        shape = tuple(self.shape[self.axis_names.index(a)] for a in axes)
        groups = {}
        for size in range(1, len(axes)):
            for sub in itertools.combinations(axes, size):
                groups[sub[0] if size == 1 else sub] = self._group(sub)
        coords = list(np.unravel_index(self.rank, self.shape))
        ranks = []
        for t in itertools.product(*(range(n) for n in shape)):
            for a, c in zip(axes, t):
                coords[self.axis_names.index(a)] = c
            ranks.append(self._world_rank(
                int(np.ravel_multi_index(coords, self.shape))))
        return dataclasses.replace(
            self, axis_names=axes, shape=shape, rank=self.index(axes),
            world=self._group(axes), groups=groups,
            world_ranks=tuple(ranks))

    def _world_rank(self, r: int) -> int:
        """The world rank of this mesh's rank ``r``."""
        return self.world_ranks[r] if self.world_ranks else r

    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        """``axis`` (None: the world; a name; a tuple of names) as a tuple
        of names."""
        if axis is None:
            return self.axis_names
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def _group(self, axes: Tuple[str, ...]):
        ordered = tuple(a for a in self.axis_names if a in axes)
        if ordered == self.axis_names:
            return self.world
        return self.groups[ordered[0] if len(ordered) == 1 else ordered]

    def extent(self, axis: Axes = None) -> int:
        """The ranks along ``axis`` (None: the world; a name; a tuple of
        names: the product of their extents)."""
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in self._axes(axis)], dtype=np.int64))

    def index(self, axis: Axes) -> int:
        """This rank's block index along ``axis``: its coordinates on the
        named axes, row-major in the order named."""
        axes = self._axes(axis)
        return int(np.ravel_multi_index(
            [self.coord(a) for a in axes],
            [self.shape[self.axis_names.index(a)] for a in axes]))

    def all_gather(self, x: torch.Tensor, axis: Axes = None,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` (None: the world; a name; a
        tuple of names in the mesh's order), concatenated along ``dim`` in
        block order: rank order along one axis, row-major over the
        coordinates of a tuple. Axes named out of the mesh's order raise
        ``ValueError``."""
        axes = self._axes(axis)
        if axes != tuple(a for a in self.axis_names if a in axes):
            raise ValueError(f"all_gather over {axes}: name the axes in the "
                             f"mesh's order {self.axis_names}")
        n = self.extent(axes)
        dim = dim % x.dim()
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self._group(axes))
        self._count("all_gather", (n - 1) * x.numel() * x.element_size(),
                    axes)
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axis: Axes = None
                   ) -> torch.Tensor:
        """The sum of every rank's ``x`` along ``axis`` (None: the world;
        a name; a tuple of names), as a new tensor."""
        axes = self._axes(axis)
        out = x.contiguous().clone()
        n = self.extent(axes)
        dist.all_reduce(out, group=self._group(axes))
        self._count("all_reduce", 2 * (n - 1) / n * out.numel()
                    * out.element_size(), axes)
        return out

    def _peer(self, axis: Optional[str], step: int) -> int:
        """The world rank ``step`` places ahead of this one along
        ``axis`` (None: the linear world), wrapping around."""
        if axis is None:
            return (self.rank + step) % self.n_shards
        coords = list(np.unravel_index(self.rank, self.shape))
        i = self.axis_names.index(axis)
        coords[i] = (coords[i] + step) % self.shape[i]
        return int(np.ravel_multi_index(coords, self.shape))

    def shift(self, x: torch.Tensor, steps: Sequence[int],
              axis: Optional[str] = None) -> List[torch.Tensor]:
        """For each ``q`` in ``steps``, the ``x`` of the rank ``q`` places
        ahead along ``axis`` (None: the linear world); this rank's ``x``
        goes to the rank ``q`` places behind. A ``q`` that lands on this
        rank is ``x`` itself. One batch of sends and receives for all of
        ``steps``; the i-th exchange carries tag i, so two steps that reach
        the same peer stay apart."""
        return self._exchange(x, steps, axis, "shift")

    def _exchange(self, x: torch.Tensor, steps: Sequence[int],
                  axis: Optional[str], op: str) -> List[torch.Tensor]:
        """:meth:`shift`, its bytes counted under ``op``."""
        x = x.contiguous()
        out: List[Optional[torch.Tensor]] = [None] * len(steps)
        ops, landed = [], []
        staged = self.staged(op)
        src = x
        if staged:
            src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            src.copy_(x)
        for i, q in enumerate(steps):
            peer_from = self._peer(axis, q)
            if peer_from == self.rank:
                out[i] = x
                continue
            buf = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                              pin_memory=staged)
            ops.append(dist.P2POp(dist.isend, src,
                                  self._world_rank(self._peer(axis, -q)),
                                  tag=i))
            ops.append(dist.P2POp(dist.irecv, buf,
                                  self._world_rank(peer_from), tag=i))
            landed.append((i, buf))
            self._count(op, x.numel() * x.element_size(), self._axes(axis))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for i, buf in landed:
            out[i] = buf.to(x.device, non_blocking=True) if staged else buf
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: Axes = None,
                       dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of every rank's ``x``
        along ``axis`` (None: the world; a name; a tuple of names in the
        mesh's order): the inverse of :meth:`all_gather`'s layout, block
        ``index(axis)`` of ``n`` equal blocks.

        A ring of ``n - 1`` shifts along the line of ``axis``: at step s
        a rank adds its own block ``(i + s + 1) mod n`` to the partial sum
        the rank ahead passed it, and after the last step holds block i
        summed over every rank (block b's terms are added from rank b - 1
        downwards, a fixed order). Each step receives one block, so a rank
        receives ``(n - 1) / n`` of ``x`` (counted under
        ``"reduce_scatter"``), where an all-reduce and a slice would
        receive twice that; gloo has no reduce-scatter of its own."""
        axes = self._axes(axis)
        if axes != tuple(a for a in self.axis_names if a in axes):
            raise ValueError(f"reduce_scatter over {axes}: name the axes in "
                             f"the mesh's order {self.axis_names}")
        line = self.view(axes)
        n, i = line.n_shards, line.rank
        dim = dim % x.dim()
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks over {axes}")
        size = x.shape[dim] // n

        def block(b):
            return x.narrow(dim, (b % n) * size, size)

        acc = block(i + 1).contiguous()
        for s in range(1, n):
            acc = line._exchange(acc, [1], None, "reduce_scatter")[0] \
                + block(i + s + 1)
        return acc


def _check_world(n: int) -> Tuple[int, str]:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: build a mesh inside a rank that "
            "launch.mesh.run_world started (or after "
            "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n}, this "
                         f"one has {world}")
    return dist.get_rank(), dist.get_backend()


def make_host_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                   device: DeviceLike = "cuda") -> ClientMesh:
    """A mesh of ``shape`` with axis names ``axes`` over every rank of the
    current world (its size must be ``prod(shape)``), ranks row-major.
    Every rank must call it, in the same order as its other collectives:
    it makes one process group for each line along each axis and along
    each set of axes short of all of them."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    rank, backend = _check_world(int(np.prod(shape)))
    dev = resolve_device(device)
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*all_gather_into_tensor.*")
    groups = {}
    for size in range(1, len(axes)):
        for sub in itertools.combinations(range(len(axes)), size):
            others = [range(s) if j not in sub else [0]
                      for j, s in enumerate(shape)]
            for base in itertools.product(*others):
                ranks = []
                for t in itertools.product(*(range(shape[i]) for i in sub)):
                    coords = list(base)
                    for i, c in zip(sub, t):
                        coords[i] = c
                    ranks.append(int(np.ravel_multi_index(coords, shape)))
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes[sub[0]] if size == 1
                           else tuple(axes[i] for i in sub)] = group
    return ClientMesh(axis_names=axes, shape=shape, rank=rank,
                      backend=backend, device=dev, world=dist.group.WORLD,
                      groups=groups)


def _world_size(n_devices: int) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"asked for {n} ranks but the world has {world}; "
                         "start them with launch.mesh.run_world")
    return n


def make_client_mesh(n_devices: int = 0,
                     device: DeviceLike = "cuda") -> ClientMesh:
    """The 1-D ``("data",)`` mesh of the client-sharded engine over
    ``n_devices`` ranks (0: the whole world)."""
    n = _world_size(n_devices)
    return make_host_mesh((n,), ("data",), device)


def make_cluster_mesh(n_clusters: int, n_devices: int = 0,
                      device: DeviceLike = "cuda") -> ClientMesh:
    """The 2-D ``("pod", "data")`` mesh with one pod row a cluster, for
    ``topology.ClusterTopology``: clients shard over both axes, so the
    in-cluster mean is an all-gather inside a pod and only the cluster
    means cross pods."""
    g = int(n_clusters)
    if g < 1:
        raise ValueError(f"n_clusters={n_clusters} must be >= 1")
    n = _world_size(n_devices)
    if n % g != 0:
        raise ValueError(
            f"{n} devices do not split into n_clusters={g} equal pod rows; "
            "pick a device count divisible by the cluster count")
    return make_host_mesh((g, n // g), ("pod", "data"), device)


def check_backend(backend: str, n_ranks: int, device: DeviceLike) -> None:
    """Raise unless ``n_ranks`` ranks of ``backend`` can run on
    ``device``: gloo anywhere, NCCL only on the card with a card a rank
    (it refuses two ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on cuda; use --backend "
                             "gloo on the CPU")
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_ranks > cards:
            raise ValueError(
                f"nccl cannot run {n_ranks} ranks on {cards} card(s): it "
                "refuses two ranks on one device ('Duplicate GPU "
                "detected'); pass --backend gloo to run them over gloo")


def default_backend(device: DeviceLike) -> str:
    """nccl on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_main(fn, args, rank: int, n: int, backend: str, device: str,
               init_method: str, timeout_s: float, results,
               out_dir: str) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            resolve_device(dev)
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        dist.destroy_process_group()
        # pickled here by value (the queue's own pickler would pass a
        # tensor's storage by a handle that dies with this process) into a
        # file, whose path the queue carries: on the H100 host 4 GB through
        # the queue took 68-72 s, through files 8.4 s
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f)
        results.put((rank, True, path))
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_world(fn: Callable, n_ranks: int, *, backend: str = "gloo",
              device: DeviceLike = "cpu", args: Tuple = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` in each of ``n_ranks`` new processes, joined in
    one ``backend`` process group on ``device``; returns the ranks'
    results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path) and so is
    each result, into a file of the world's temporary directory: return
    host values. The processes start by ``spawn`` (the caller may hold a
    CUDA context), meet at a ``file://`` rendezvous in that directory (no
    port), and a rank on the CPU runs one torch thread. On the card rank r takes card ``r % device_count``; the
    kernels are built here first, so that no rank builds. If any rank
    fails, the others get FAILURE_GRACE_S to end before they are
    terminated, and this raises with every failed rank's traceback."""
    check_backend(backend, n_ranks, device)
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        resolve_device(dev)
        _build.build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, tuple(args), r, n_ranks, backend,
                                   str(dev), init_method, timeout_s,
                                   results, tmp))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        done: Dict[int, Any] = {}
        failed: Dict[int, str] = {}
        deadline = time.monotonic() + timeout_s
        while len(done) + len(failed) < n_ranks:
            if time.monotonic() > deadline:
                break
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in failed \
                            and r not in done:
                        failed[r] = f"rank {r} exited with {p.exitcode}"
                if failed:
                    deadline = min(deadline,
                                   time.monotonic() + FAILURE_GRACE_S)
                continue
            if ok:   # the file a rank wrote
                with open(out, "rb") as f:
                    done[rank] = pickle.load(f)
                os.remove(out)
            else:
                failed[rank] = out
            if failed:
                deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
        for p in procs:
            p.join(timeout=FAILURE_GRACE_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=FAILURE_GRACE_S)
        missing = [r for r in range(n_ranks) if r not in done]
        if failed or missing:
            detail = "\n".join(
                f"--- rank {r} ---\n{failed.get(r, 'no result')}"
                for r in missing)
            raise RuntimeError(f"{len(missing)} of {n_ranks} {backend} "
                               f"ranks failed:\n{detail}")
    return [done[r] for r in range(n_ranks)]
