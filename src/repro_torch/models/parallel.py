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
``w_gate`` / ``w_uq`` / ``w_uk`` / ``w_uv`` / ``w_up`` (and the xLSTM's
gate projections) is narrower than the config's width, and a row block
of ``w_o`` / ``w_out`` / ``w_down`` shorter, in which case its product is
a partial sum over the model axes; a vocab block of
``embed`` is shorter than the vocab; an expert block of the MoE's
``[E, ...]`` stacks holds fewer than ``E`` experts. A dim that does not
divide by the model extent stays whole (``specs._div``) and its function
runs whole beside split ones. Leaves split over the FSDP axes are
gathered just before the block that reads them runs
(:meth:`Parallel.unshard`) and dropped after it.

By block kind, over the model axes:

  GQA     query / kv head blocks, ``w_o``'s row block (``attention.py``)
  MLA     head blocks of ``w_uq`` / ``w_uk`` / ``w_uv`` over the latents
          every rank computes whole, ``w_o``'s row block; in decode a
          cache split on its positions combines the blocks' partial
          softmaxes in the latent space (``attention.py``)
  Mamba   channel blocks of d_in: ``w_in``'s column block of ``[u | z]``
          gathered and re-cut to the rank's channels of u and of z,
          ``w_x``'s row block summed, the scan on the rank's channels,
          ``w_out``'s row block summed (``ssm.py``)
  MoE     expert blocks: every rank routes the same tokens, dispatches
          the choices its experts take, and the weighted outputs are
          summed over the model ranks (``moe.py``); no all-to-all
  mLSTM   channel blocks of d_in, which are head blocks: ``w_up``'s column
          block of ``[u | z]`` gathered and re-cut (:func:`column_pair`),
          the conv on the rank's channels, u gathered once for the
          column blocks of ``w_q`` / ``w_k`` / ``w_v`` / ``w_i`` /
          ``w_f``, the recurrence on the rank's heads, the output norm's
          statistic summed over the model ranks, ``w_down``'s row block
          summed (``xlstm.py``)
  sLSTM   the same with a plain column block of ``w_up``; the input
          projections of all T steps on the rank's heads before the time
          loop, so no collective runs inside it (``xlstm.py``)
  front   the VLM's patches whole beside the vocab-split lookup of its
  -ends   text; the audio encoder's positional conv on the rank's channels,
          gathered whole (``transformer.py``)

A block whose column blocks cut a head (H not dividing by the model
extent while d_in does) gathers the projections' columns over the model
axes and runs every head on every rank, its row block taking the rank's
channels (GQA's ``attention._heads``, MLA's weights, the xLSTM blocks).

Under autograd (the train step on a mesh) the collectives over the model
axes are differentiable, by Megatron's convention: every model rank
computes the whole loss, so an activation outside a split block is
replicated and so is its gradient.

  ``enter_model``   at the input of a column block (one call for q, k and
                    v, which share it): identity; its gradient is the sum
                    of the model ranks' partial gradients (all-reduce)
  ``sum_model``     after a row block: the all-reduce of the partial sums;
                    its gradient passes through (every rank already holds
                    the whole gradient of the sum)
  ``gather_model``  where a block cuts a head (or Mamba's ``[u | z]``
                    block): the all-gather of the blocks; its gradient is
                    this rank's block of the sum of the ranks' gradients,
                    a reduce-scatter (each rank reads the gathered heads
                    only through its own query heads or its own columns
                    of ``w_o``, so each holds a partial gradient)
  ``gather_whole``  the all-gather of a block that every rank then reads
                    whole, alike (a leaf split where the block that reads
                    it runs whole: no partial sum follows); its gradient,
                    whole on every rank, is cut to this rank's block

``torch.distributed.nn.functional``'s collectives are not used: their
backward sums over the ranks, which would count a loss replicated on the
model ranks once a rank. A replicated leaf read inside a split block (the
qk-norm scales) goes through ``enter_model`` too, so that its gradient,
partial on each rank, is summed and the replicas stay equal. Without
grad (serving, the eval loss) each issues exactly the collective it did
before: ``enter_model`` none.

The L2 layout of the train step (``batch_loss``: each client's rows split
over the batch axes, its params over the FSDP axes, which are the same
axes) follows the same convention over the batch axes: every batch rank
computes the client's whole loss, each from its own rows, so a param's
gradient on a rank is that rank's rows' part and is summed over the batch
ranks on its way back to the leaf.

  ``unshard``       under grad, an FSDP-split leaf is all-gathered along
                    its split dim (its model block kept); its gradient is
                    this rank's block of the sum over the FSDP axes, a
                    reduce-scatter (``ClientMesh.reduce_scatter``, a ring
                    of shifts over gloo)
  ``enter_params``  every other leaf (the norms, the router, the qk-norm
                    scales, a leaf whose dim does not divide by the data
                    extent): identity; its gradient is all-reduced over
                    the batch axes (``enter_batch``)
  ``sum_batch``     the loss's terms (the cross-entropy's sum and count,
                    the MoE's mean router probabilities): the all-reduce
                    over the batch axes; the gradient passes through

Without grad ``unshard`` keeps ``specs.relayout``, bitwise as in serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.sharding import specs as specs_lib


class _SumModel(torch.autograd.Function):
    """Forward the all-reduce over ``axes``, backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterModel(torch.autograd.Function):
    """Forward the identity, backward the all-reduce over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """Forward the all-gather over ``axes`` along ``dim``, backward this
    rank's block of the gradient summed over ``axes`` (the
    reduce-scatter, ``ClientMesh.reduce_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        # eager torch's gather, materialized (RL302 guards XLA's)
        # repro-lint: disable=RL302
        return mesh.all_gather(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, \
            None


class _GatherWhole(torch.autograd.Function):
    """Forward the all-gather over ``axes`` along ``dim``, backward this
    rank's block of the gradient (every rank holds the whole of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.index, ctx.dim, ctx.size = mesh.index(axes), dim, x.shape[dim]
        # repro-lint: disable=RL302
        return mesh.all_gather(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def column_pair(par, x: torch.Tensor, w: torch.Tensor, width: int, c: int,
                tp: bool):
    """(a, b): the ``c`` channels this rank computes of each half of a
    fused projection ``x @ w = [a | b]`` of ``2 width`` columns (Mamba's
    ``w_in``, the mLSTM's ``w_up``). Under ``tp`` they are the rank's block
    of ``width`` channels, else every channel. A column block of ``w`` (its
    ``[a | b]`` columns cut in contiguous blocks over the model axes: at
    model 2 a block is all of a or all of b) is gathered and re-cut, ``x``
    entering it; read whole (not ``tp``) its gather's gradient is cut, not
    summed (``gather_whole``)."""
    split = par is not None and w.shape[-1] < 2 * width
    if split:
        x = par.enter_model(x)
    xz = x @ w
    if split:
        xz = par.gather_model(xz, -1) if tp else par.gather_whole(xz, -1)
    lo = par.model_index * c if tp else 0
    return xz[..., lo:lo + c], xz[..., width + lo:width + lo + c]


@dataclasses.dataclass(eq=False)
class Parallel:
    """``mesh``: this rank's ``ClientMesh``; ``plan``: the step's
    ``ShardingPlan``; ``param_specs``: ``{path: spec}`` of every param
    leaf (``tree.flatten(param_pspecs(...), tuples=False)``); ``seq_axes``:
    the axes of extent > 1 the decode cache's positions are split over
    (() when each rank holds every position); ``batch_loss``: the train
    step's L2 layout, where a client's rows are split over the batch axes
    and its loss is the mean over all of them (:meth:`sum_batch`), the
    same on every rank (serving leaves it off: each rank's own rows)."""
    mesh: Any
    plan: specs_lib.ShardingPlan
    param_specs: Dict[str, specs_lib.Spec]
    seq_axes: specs_lib.Axes = ()
    batch_loss: bool = False

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
        """The sum of the model ranks' partial ``x`` (its gradient passes
        through)."""
        if _differentiated(x):
            return _SumModel.apply(x, self.mesh, self.model_axes)
        return self.mesh.all_reduce(x, self.model_axes)

    def enter_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` at the input of a column block over the model axes: the
        same values; under autograd its gradient is summed over the model
        ranks. The identity with no model axis or without grad."""
        if self.model_axes and _differentiated(x):
            return _EnterModel.apply(x, self.mesh, self.model_axes)
        return x

    def sum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the batch ranks' partial ``x`` (its gradient passes
        through); ``x`` without batch axes."""
        if not self.batch_axes:
            return x
        if _differentiated(x):
            return _SumModel.apply(x, self.mesh, self.batch_axes)
        return self.mesh.all_reduce(x, self.batch_axes)

    def enter_batch(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated leaf read by this rank's rows: the same values;
        under autograd its gradient is summed over the batch ranks. The
        identity with no batch axis or without grad."""
        if self.batch_axes and _differentiated(x):
            return _EnterModel.apply(x, self.mesh, self.batch_axes)
        return x

    def _fsdp_dims(self, spec: specs_lib.Spec) -> list:
        """[(dim, axes)] of the dims ``spec`` splits over FSDP axes of
        extent > 1."""
        fsdp = set(self.plan.fsdp_axes)
        return [(d, self._split(e)) for d, e in enumerate(spec)
                if e and set(e) <= fsdp and self._split(e)]

    def enter_params(self, params: Any) -> Any:
        """``params`` (one client's tree) with each leaf that no FSDP axis
        splits entering the batch (:meth:`enter_batch`); the FSDP-split
        leaves sum their gradients in :meth:`unshard`'s reduce-scatter.
        The tree itself unless the loss is the batch's
        (``batch_loss``)."""
        if not (self.batch_loss and self.batch_axes):
            return params

        def one(path, x):
            if self._fsdp_dims(self.param_specs[path]):
                return x
            return self.enter_batch(x)

        return tree_lib.map_with_path(one, params)

    # the gathers below are eager torch's, materialized: no reduction can
    # fuse across them (repro-lint's RL302 guards XLA's gathers)
    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every model rank's ``x`` along ``dim``; under autograd the
        gradient of this rank's block is its block of the ranks' summed
        gradients."""
        dim = dim % x.dim()
        if _differentiated(x):
            return _Gather.apply(x, self.mesh, self.model_axes, dim)
        # repro-lint: disable=RL302
        return self.mesh.all_gather(x, self.model_axes, dim=dim)

    def gather_whole(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every model rank's ``x`` along ``dim``, for a block that each
        rank runs whole (no partial sum follows); under autograd the
        gradient of this rank's block is its block of its own gradient."""
        dim = dim % x.dim()
        if _differentiated(x):
            return _GatherWhole.apply(x, self.mesh, self.model_axes, dim)
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
        axis. Under autograd each gather is differentiable, its gradient
        reduce-scattered back to the block (:class:`_Gather`);
        without grad the leaves go through ``specs.relayout``."""
        fsdp = self._split(self.plan.fsdp_axes)
        if not fsdp:
            return tree

        def one(sub, x):
            spec = self.param_specs[f"{path}/{sub}" if sub else path]
            if stacked:
                spec = spec[1:]
            if _differentiated(x):
                for d, axes in self._fsdp_dims(spec):
                    x = _Gather.apply(x, self.mesh, axes, d)
                return x.contiguous()
            want = tuple(None if e and set(e) <= set(self.plan.fsdp_axes)
                         else e for e in spec)
            return specs_lib.relayout(x, spec, want, self.mesh)

        return tree_lib.map_with_path(one, tree)
