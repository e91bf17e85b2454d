"""One rank's part in an LM step placed on a mesh (``launch/steps.py``).

The reference hands its step ``in_shardings`` and lets GSPMD derive the
collectives. The port runs one process a rank, so the split a spec
implies is written by hand, and :class:`Parallel` carries what the model
functions need for it: the rank's mesh (``launch.mesh.ClientMesh``), the
plan, the spec of every param leaf, and the axes the decode cache's
positions are split over. Called with ``par=None`` every model function
computes what it computes on one device.

The split each function takes is read from the leaves it is handed, not
from the arch: a column block of ``w_q`` / ``w_k`` / ``w_v`` / ``w_in`` /
``w_gate`` is narrower than the config's width, and a row block of
``w_o`` / ``w_out`` shorter, in which case its product is a partial sum
over the model axes; a vocab block of ``embed`` is shorter than the
vocab. Leaves split over the FSDP axes are gathered just before the block
that reads them runs (:meth:`Parallel.unshard`) and dropped after it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.sharding import specs as specs_lib


@dataclasses.dataclass(eq=False)
class Parallel:
    """``mesh``: this rank's ``ClientMesh``; ``plan``: the step's
    ``ShardingPlan``; ``param_specs``: ``{path: spec}`` of every param
    leaf (``tree.flatten(param_pspecs(...), tuples=False)``); ``seq_axes``:
    the axes of extent > 1 the decode cache's positions are split over
    (() when each rank holds every position)."""
    mesh: Any
    plan: specs_lib.ShardingPlan
    param_specs: Dict[str, specs_lib.Spec]
    seq_axes: specs_lib.Axes = ()

    def _split(self, axes) -> specs_lib.Axes:
        return specs_lib.split_entry(tuple(axes), self.mesh) or ()

    @property
    def model_axes(self) -> specs_lib.Axes:
        """The model axes of extent > 1 (() when heads are not split)."""
        return self._split(self.plan.model_axes)

    @property
    def batch_axes(self) -> specs_lib.Axes:
        return self._split(self.plan.batch_axes)

    @property
    def model_index(self) -> int:
        return self.mesh.index(self.model_axes) if self.model_axes else 0

    @property
    def batch_index(self) -> int:
        return self.mesh.index(self.batch_axes) if self.batch_axes else 0

    @property
    def seq_index(self) -> int:
        return self.mesh.index(self.seq_axes) if self.seq_axes else 0

    @property
    def seq_extent(self) -> int:
        return self.mesh.extent(self.seq_axes) if self.seq_axes else 1

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the model ranks' partial ``x``."""
        return self.mesh.all_reduce(x, self.model_axes)

    # the gathers below are eager torch's, materialized: no reduction can
    # fuse across them (repro-lint's RL302 guards XLA's gathers)
    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        # repro-lint: disable=RL302
        return self.mesh.all_gather(x, self.model_axes, dim=dim)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch block's ``x`` (rows along dim 0), in row order."""
        # repro-lint: disable=RL302
        return self.mesh.all_gather(x, self.batch_axes, dim=0)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every position block's ``x``, stacked along dim 0 in block
        order (``x`` gains a leading dim of the seq extent)."""
        # repro-lint: disable=RL302
        return self.mesh.all_gather(x[None], self.seq_axes, dim=0)

    def unshard(self, tree: Any, path: str, stacked: bool = False) -> Any:
        """The leaves under ``path`` with their FSDP blocks gathered (the
        model blocks kept). ``stacked``: ``tree`` is one period of a
        period-stacked block, whose leaves' specs lead with the period
        axis."""
        fsdp = self._split(self.plan.fsdp_axes)
        if not fsdp:
            return tree

        def one(sub, x):
            spec = self.param_specs[f"{path}/{sub}" if sub else path]
            if stacked:
                spec = spec[1:]
            want = tuple(None if e and set(e) <= set(self.plan.fsdp_axes)
                         else e for e in spec)
            return specs_lib.relayout(x, spec, want, self.mesh)

        return tree_lib.map_with_path(one, tree)
