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

  ``all_gather``  blocks of every rank of an axis (or of the world),
                  concatenated along dim 0 in rank order
  ``all_reduce``  the sum over the world
  ``shift``       for each ``q``, the block of the rank ``q`` places
                  ahead along an axis (or the linear world), as one batch
                  of sends and receives

NCCL refuses two ranks on one card, so on one GPU the ranks run over gloo,
which moves CUDA tensors through host memory. An op that gloo does not take
on CUDA tensors is staged through pinned host buffers here, by name
(:data:`GLOO_CUDA_STAGED`), and :attr:`ClientMesh.transport` reports each
op's transport; the arithmetic stays on the card. gloo ranks sharing one
card measure no multi-GPU communication.

The JAX package's ``make_production_mesh`` and its TPU constants have no
counterpart: the port's meshes are the ranks a caller starts.
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("gloo", "nccl")

# ops whose CUDA tensors gloo does not move: they go through pinned host
# buffers (the point-to-point sends and receives of ``shift``)
GLOO_CUDA_STAGED = frozenset({"shift"})

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
    group of every rank. ``received`` counts the analytic bytes each op
    received on this rank (an all-gather the other ranks' blocks, an
    all-reduce a ring's ``2 (n - 1) / n`` of its tensor, a shift the block
    it took), for the communication a round moves.

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
    received: Dict[str, int] = dataclasses.field(default_factory=dict)

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
                for op in ("all_gather", "all_reduce", "shift")}

    def _count(self, op: str, nbytes: float) -> None:
        self.received[op] = self.received.get(op, 0) + int(nbytes)

    def _group(self, axis: Optional[str]):
        return self.world if axis is None else self.groups[axis]

    def _extent(self, axis: Optional[str]) -> int:
        return self.n_shards if axis is None else \
            self.shape[self.axis_names.index(axis)]

    def all_gather(self, x: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` (None: the world),
        concatenated along dim 0 in rank order."""
        n = self._extent(axis)
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self._group(axis))
        self._count("all_gather", (n - 1) * x.numel() * x.element_size())
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (a new tensor)."""
        out = x.contiguous().clone()
        n = self.n_shards
        dist.all_reduce(out, group=self.world)
        self._count("all_reduce", 2 * (n - 1) / n * out.numel()
                    * out.element_size())
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
        x = x.contiguous()
        out: List[Optional[torch.Tensor]] = [None] * len(steps)
        ops, landed = [], []
        staged = self.staged("shift")
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
            ops.append(dist.P2POp(dist.isend, src, self._peer(axis, -q),
                                  tag=i))
            ops.append(dist.P2POp(dist.irecv, buf, peer_from, tag=i))
            landed.append((i, buf))
            self._count("shift", x.numel() * x.element_size())
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for i, buf in landed:
            out[i] = buf.to(x.device, non_blocking=True) if staged else buf
        return out


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
    it makes one process group for each line along each axis."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    rank, backend = _check_world(int(np.prod(shape)))
    dev = resolve_device(device)
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*all_gather_into_tensor.*")
    groups = {}
    for i, name in enumerate(axes):
        others = [range(s) if j != i else [0] for j, s in enumerate(shape)]
        for base in itertools.product(*others):
            ranks = []
            for t in range(shape[i]):
                coords = list(base)
                coords[i] = t
                ranks.append(int(np.ravel_multi_index(coords, shape)))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
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
               init_method: str, timeout_s: float, results) -> None:
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
        # pickled here by value: the queue's own pickler would pass a
        # tensor's storage by a handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
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
    each result: return host values. The processes start by ``spawn``
    (the caller may hold a CUDA context), meet at a ``file://`` rendezvous
    in a temporary directory (no port), and a rank on the CPU runs one
    torch thread. On the card rank r takes card ``r % device_count``; the
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
                                   results))
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
            if ok:
                done[rank] = pickle.loads(out)   # bytes a rank wrote
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
