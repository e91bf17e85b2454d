"""The cost of an eager step, counted from the ops it dispatches (the
JAX package's ``launch/hlo_analysis.py``, which parses compiled HLO).

There is no HLO here: a step runs op by op, so :class:`CostCounter`, a
``TorchDispatchMode``, sees every aten op the step dispatches (forward and
backward, on meta tensors as on real ones) and counts, per rank:

- ``flops``: 2·M·N·K for every matmul-class op (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``convolution`` and ``convolution_backward``),
  the reference's rule for ``dot`` and ``conv``, plus what each
  hand-written kernel reports for itself (below);
- ``hbm_bytes``: the operand and output bytes of every op that is not a
  view (a mutated operand counted once, as written). In eager every op is
  a kernel that reads its operands from HBM and writes its outputs there:
  the analogue of the reference's fusion-boundary bytes. An op that only
  allocates (``empty``) or reads metadata counts nothing;
- ``collective_bytes``: the bytes this rank *receives*, by op and by axes,
  as ``launch.mesh.ClientMesh`` counts them (``received_by_axes``: an
  all-gather the other ranks' blocks, an all-reduce a ring's ``2 (n - 1)
  / n`` of its tensor, a shift the block it takes, a reduce-scatter its
  ring's ``n - 1`` blocks). The reference counts a collective's operand
  bytes, so these are not comparable with its ``collective_bytes``;
- ``attention_masked_flops``: the flops of the (row, key) pairs the
  attention masks skip, at the flash kernel's rate, which the reference's
  einsum attention computes and the kernel does not (``flops +
  attention_masked_flops`` is the reference's count of an attention).

The hand-written kernels are ctypes launches, not aten ops, so the counter
cannot see them: each kernel's wrapper reports its flops and bytes
(:func:`kernel`) on every device. On the card and on meta tensors it
reports and then launches (or, on meta, allocates the outputs and
launches nothing); on the CPU its plain twin runs inside :func:`kernel`,
whose ops the counter does not count, so that a call costs what the
kernel's formula says wherever it runs. The formulas are the kernel
table's (``PERF.md`` §6): flash 4·D flops a kept (row, key) pair forward
and 10·D backward, the scan 5·ds + 3 flops a (row, step, channel) with its
inputs and outputs, the FL kernels' leaves read and written once, the
race 12 integer ops a hash (counted as flops).

A loop of identical trips may be traced once and counted as many times
(:func:`repeated`): the dry-run does so for the sLSTM's time loop on meta
tensors (``models/xlstm.py``).

The counter also follows the live storages (:attr:`Costs.peak_live_bytes`:
the largest sum of the bytes of the storages alive at once among those
it saw made or passed in), by a ``weakref.finalize`` on each storage;
storages made outside its view and never passed to an op are not seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Dict, Iterator, List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

COLLECTIVES = ("all_gather", "all_reduce", "shift", "reduce_scatter")

# ops that read no data and write none: allocation, metadata and host
# reads of a scalar
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "resize_", "set_", "is_same_size",
    "_unsafe_view"})
# in-place scatters: they write the region their values cover, not the
# whole tensor (the reference's rule for a dynamic-update-slice)
_SCATTERS = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                       "index_add_", "scatter_", "scatter_add_",
                       "scatter_reduce_", "masked_scatter_"})


def _mm_flops(func, args, out) -> float:
    """2·M·N·K of a matmul-class op (its batch dims included)."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    if name == "convolution":   # weight [C_out, C_in / groups, *kernel]
        w = args[1]
        return 2.0 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))
    if name == "convolution_backward":   # grad input and grad weight
        grad_out, w, mask = args[0], args[2], args[10]
        per = 2.0 * grad_out.numel() * w.shape[1] * math.prod(w.shape[2:])
        return per * (int(mask[0]) + int(mask[1]))
    return 0.0


_MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "convolution",
                      "convolution_backward"})


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_SCHEMAS: Dict[object, tuple] = {}


def _schema(func) -> tuple:
    """(is a view, the indices of the arguments it writes) of an op."""
    if func not in _SCHEMAS:
        args = func._schema.arguments
        written = frozenset(i for i, a in enumerate(args)
                            if a.alias_info is not None
                            and a.alias_info.is_write)
        view = any(a.alias_info is not None and not a.alias_info.is_write
                   for a in args)
        _SCHEMAS[func] = (view, written)
    return _SCHEMAS[func]


def _tensor_bytes(tree) -> int:
    return sum(_bytes(leaf) for leaf in pytree.tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


@dataclasses.dataclass
class Costs:
    """One step's per-rank costs (the reference's ``hlo_analysis.Costs``
    and its ``analyze_dict`` keys, :meth:`as_dict`)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    attention_masked_flops: float = 0.0
    # ``ClientMesh.received_by_axes``'s keys: "<op> over <axes>"
    collective_by_axes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    # kernel name -> {"calls", "flops", "hbm_bytes", "masked_flops"}
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_by_axes.values()))

    def collective_by_op(self) -> Dict[str, float]:
        out = {op: 0.0 for op in COLLECTIVES}
        for key, n in self.collective_by_axes.items():
            op = key.split(" over ")[0]
            out[op] = out.get(op, 0.0) + n
        return out

    def add(self, other: "Costs", mult: float = 1.0) -> None:
        """Add ``other`` times ``mult`` (the peak is the larger one)."""
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.attention_masked_flops += other.attention_masked_flops * mult
        for mine, theirs in ((self.collective_by_axes,
                              other.collective_by_axes),
                             (self.collective_counts,
                              other.collective_counts),
                             (self.bytes_by_op, other.bytes_by_op),
                             (self.flops_by_op, other.flops_by_op),
                             (self.count_by_op, other.count_by_op)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * mult
        for name, row in other.kernels.items():
            mine = self.kernels.setdefault(name, dict.fromkeys(row, 0.0))
            for k, v in row.items():
                mine[k] = mine.get(k, 0.0) + v * mult
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)

    def as_dict(self) -> dict:
        """``analyze_dict``'s keys (``flops``, ``hbm_bytes``,
        ``collective_bytes``, each collective's bytes and ``n_<op>``) and
        the port's own: ``attention_masked_flops``, ``collective_by_axes``,
        ``bytes_by_op``, ``flops_by_op``, ``count_by_op``, ``kernels``,
        ``peak_live_bytes``."""
        out = {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
               "collective_bytes": self.collective_bytes,
               "attention_masked_flops": self.attention_masked_flops}
        out.update(self.collective_by_op())
        for op in COLLECTIVES:
            out[f"n_{op}"] = sum(n for k, n in self.collective_counts.items()
                                 if k.split(" over ")[0] == op)
        out.update(collective_by_axes=dict(self.collective_by_axes),
                   bytes_by_op=dict(self.bytes_by_op),
                   flops_by_op=dict(self.flops_by_op),
                   count_by_op=dict(self.count_by_op),
                   kernels={k: dict(v) for k, v in self.kernels.items()},
                   peak_live_bytes=self.peak_live_bytes)
        return out


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)`` counts the step's costs into
    ``c.costs`` (module docstring), and follows the live storages for
    ``costs.peak_live_bytes``; ``live(*trees)`` enters tensors made before
    the counter (a step's inputs) into that sum."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._paused = 0
        self._mult = 1   # :func:`repeated`'s trips
        self._live: Dict[int, int] = {}
        self._live_sum = 0

    # -- live storages ------------------------------------------------
    def _free(self, key: int) -> None:
        self._live_sum -= self._live.pop(key, 0)

    def _enter(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._live_sum += st.nbytes()
        weakref.finalize(st, self._free, key)
        if self._live_sum > self.costs.peak_live_bytes:
            self.costs.peak_live_bytes = self._live_sum

    def live(self, *trees) -> None:
        """Count the tensors in ``trees`` as live (a step's inputs)."""
        for leaf in pytree.tree_leaves(trees):
            if isinstance(leaf, torch.Tensor):
                self._enter(leaf)

    # -- reports from outside the dispatcher --------------------------
    def add_kernel(self, name: str, flops: float, hbm_bytes: float,
                   masked_flops: float = 0.0) -> None:
        c, k = self.costs, self._mult
        c.flops += k * flops
        c.hbm_bytes += k * hbm_bytes
        c.attention_masked_flops += k * masked_flops
        row = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                          "hbm_bytes": 0.0,
                                          "masked_flops": 0.0})
        row["calls"] += k
        row["flops"] += k * flops
        row["hbm_bytes"] += k * hbm_bytes
        row["masked_flops"] += k * masked_flops

    def add_collective(self, key: str, nbytes: float) -> None:
        c, k = self.costs, self._mult
        c.collective_by_axes[key] = c.collective_by_axes.get(key, 0) \
            + k * int(nbytes)
        c.collective_counts[key] = c.collective_counts.get(key, 0) + k

    # -- the dispatcher -----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func.overloadpacket.__name__
        c, k = self.costs, self._mult
        c.count_by_op[name] = c.count_by_op.get(name, 0) + k
        view, written = _schema(func)
        if func.namespace == "aten" and name not in _FREE and not view:
            n = sum(_tensor_bytes(a) for i, a in enumerate(args)
                    if i not in written)
            n += sum(_tensor_bytes(a) for k, a in kwargs.items()
                     if k != "out")
            if name in _SCATTERS:   # the values (its last tensor), written
                n += _bytes([leaf for leaf in pytree.tree_leaves(args)
                             if isinstance(leaf, torch.Tensor)][-1])
            else:
                n += _tensor_bytes(out)
            c.hbm_bytes += k * n
            c.bytes_by_op[name] = c.bytes_by_op.get(name, 0) + k * n
            if name in _MATMULS:
                f = k * _mm_flops(func, args, out)
                c.flops += f
                c.flops_by_op[name] = c.flops_by_op.get(name, 0) + f
        for leaf in pytree.tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                self._enter(leaf)
        return out


def active() -> List[CostCounter]:
    """The counters active on this thread, outermost first."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostCounter)]


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], tuple]) -> Iterator[None]:
    """Report one call of the hand-written kernel ``name`` to every active
    counter (``cost()``: its flops, bytes and masked flops, evaluated only
    when a counter is active), and count none of the ops dispatched inside
    the block (the CPU's plain twin standing in for it)."""
    counters = active()
    if counters:
        row = cost()
    for c in counters:
        c.add_kernel(name, *row)
        c._paused += 1
    try:
        yield
    finally:
        for c in counters:
            c._paused -= 1


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Count everything inside the block ``n`` times in every active
    counter: a loop body traced once for a loop of ``n`` identical trips
    (the reference's HLO count multiplies a loop body by its trip
    count)."""
    counters = active()
    before = [c._mult for c in counters]
    for c in counters:
        c._mult *= int(n)
    try:
        yield
    finally:
        for c, m in zip(counters, before):
            c._mult = m


def report_kernel(name: str, cost: Callable[[], tuple]) -> None:
    """Report one call of the kernel ``name`` (a launch, or its meta
    stand-in) to every active counter; ``cost()`` as in :func:`kernel`."""
    counters = active()
    if counters:
        row = cost()
        for c in counters:
            c.add_kernel(name, *row)


def report_collective(key: str, nbytes: float) -> None:
    """Report ``nbytes`` received by one collective under ``key`` ("<op>
    over <axes>") to every active counter."""
    for c in active():
        if not c._paused:
            c.add_collective(key, nbytes)
