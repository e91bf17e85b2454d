"""Placement rules for every parameter, batch and decode-state tensor of
an LM (the JAX package's ``sharding/specs.py``), and the blocks a rank
holds under them.

Layouts, as the reference names them:
  L1 "client-sharded": the client axis C sharded over ``data`` (x
      ``pod``); aggregation is the all-reduce over the client axis.
  L2 "client-replicated + FSDP": for giant models C is small and
      replicated, and the parameters are sharded over ``data`` (FSDP);
      each client's local batch is data-parallel.

The rules are the reference's, by leaf name and block kind over the paths
``tree.map_with_path`` gives (``"period/j0/mixer/w_q"``); anything
unmatched is replicated. A leaf's spec is a tuple with one entry per dim,
each ``None`` (whole) or a tuple of mesh axis names (the dim split into
blocks over those axes, row-major over their coordinates, as a
``NamedSharding`` splits it); the reference has a ``PartitionSpec`` here.
An axis of extent 1 splits nothing.

The rules need only the mesh's axis extents: :class:`MeshShape` is a mesh
of extents (and a rank, for :func:`shard_tree`) with no process group, so
the production meshes (16 x 16, 2 x 16 x 16) are checked without ranks;
``launch.mesh.ClientMesh`` has the same ``axes``, ``axis_names``,
``shape``, ``rank`` and ``coord``. :func:`shard_tree` and
:func:`gather_tree` stand for the reference's ``to_shardings`` plus
``device_put`` and its gather of a sharded array to the host;
:func:`relayout` moves one rank's block from one spec to another with the
mesh's collectives.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import map_with_path, tree_map

Axes = Tuple[str, ...]
Entry = Optional[Axes]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Static description of how one run is laid out on the mesh."""
    n_clients: int
    client_axes: Axes                   # () => client axis replicated (L2)
    batch_axes: Axes                    # per-client batch / serve batch axes
    model_axes: Axes = ("model",)
    fsdp_axes: Axes = ()                # () => no FSDP
    seq_axes: Axes = ()                 # decode-cache sequence sharding


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh of axis extents with no process group: ``axis_names`` with
    extents ``shape``, and the ``rank`` whose blocks :func:`shard_tree`
    takes (row-major over the axes)."""
    axis_names: Axes
    shape: Tuple[int, ...]
    rank: int = 0

    @property
    def axes(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(zip(self.axis_names, self.shape))

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.shape))

    def coord(self, axis: str) -> int:
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(axis)])


def _extent(mesh, axes: Sequence[str]) -> int:
    extents = dict(mesh.axes)
    n = 1
    for a in axes:
        n *= extents[a]
    return n


def _div(dim: int, mesh, axes: Axes) -> Entry:
    """axes if dim divisible by their extent (and axes non-empty) else
    None."""
    if not axes:
        return None
    return axes if dim % _extent(mesh, axes) == 0 else None


def _kind_of_path(cfg: ModelConfig, path: str) -> str:
    m = re.search(r"period/j(\d+)", path)
    if m:
        return cfg.pattern[int(m.group(1))]
    return "attn"  # prefix blocks are attention


def _param_spec(cfg: ModelConfig, mesh, plan: ShardingPlan, path: str,
                shape: Tuple[int, ...]) -> Spec:
    """Spec for one leaf EXCLUDING client/period leading axes (handled by
    the caller); ``shape`` here is the per-layer logical shape."""
    mdl, fsdp = plan.model_axes, plan.fsdp_axes
    name = path.split("/")[-1]
    kind = _kind_of_path(cfg, path)
    nd = len(shape)

    def spec(*entries):
        return tuple(entries) + (None,) * (nd - len(entries))

    if name == "embed":
        return spec(_div(shape[0], mesh, mdl), _div(shape[1], mesh, fsdp))
    if name == "lm_head":
        return spec(_div(shape[0], mesh, fsdp), _div(shape[1], mesh, mdl))
    if name in ("w_q", "w_uq", "w_up"):
        return spec(_div(shape[0], mesh, fsdp), _div(shape[1], mesh, mdl))
    if name in ("w_k", "w_v") and kind == "attn":
        return spec(_div(shape[0], mesh, fsdp), _div(shape[1], mesh, mdl))
    if name == "w_o" and kind == "attn":
        return spec(_div(shape[0], mesh, mdl), _div(shape[1], mesh, fsdp))
    if name in ("w_dkv", "w_dq"):
        return spec(_div(shape[0], mesh, fsdp), None)
    if name in ("w_uk", "w_uv"):
        return spec(None, _div(shape[1], mesh, mdl))
    if name in ("w_in", "w_gate"):
        if nd == 3:  # MoE experts [E, D, F]: expert-parallel + FSDP on F
            return spec(_div(shape[0], mesh, mdl), None,
                        _div(shape[2], mesh, fsdp))
        return spec(_div(shape[0], mesh, fsdp), _div(shape[1], mesh, mdl))
    if name == "w_out":
        if nd == 3:  # [E, F, D]: the output dim FSDP-sharded, not F
            return spec(_div(shape[0], mesh, mdl), None,
                        _div(shape[2], mesh, fsdp))
        return spec(_div(shape[0], mesh, mdl), _div(shape[1], mesh, fsdp))
    if name == "router":
        return spec(None, None)
    # --- SSM ---
    if name == "w_x":
        return spec(_div(shape[0], mesh, mdl), None)
    if name == "w_dt":
        return spec(None, _div(shape[1], mesh, mdl))
    if name == "a_log":
        return spec(_div(shape[0], mesh, mdl), None)
    if name in ("d_skip", "dt_bias"):
        return spec(_div(shape[0], mesh, mdl))
    # --- xLSTM (square projections inside the up-projected space) ---
    if name in ("w_z", "w_i", "w_f", "w_o", "w_k", "w_v"):  # non-attn kinds
        return spec(None, _div(shape[1], mesh, mdl))
    if name in ("r_z", "r_i", "r_f", "r_o"):
        return spec(_div(shape[0], mesh, mdl), None, None)
    if name == "w_down":
        return spec(_div(shape[0], mesh, mdl), _div(shape[1], mesh, fsdp))
    if name == "f_bias":
        return spec(_div(shape[0], mesh, mdl))
    if name == "w" and "conv" in path:  # depthwise conv [W, C]
        return spec(None, _div(shape[1], mesh, mdl))
    if name == "b" and "conv" in path:
        return spec(_div(shape[0], mesh, mdl))
    if name == "scale" and path.endswith("o_norm/scale"):
        return spec(_div(shape[0], mesh, mdl))
    # norms, biases, mask_emb, pos_conv, everything else: replicated
    return (None,) * nd


def param_pspecs(cfg: ModelConfig, mesh, plan: ShardingPlan,
                 params_tree: Any) -> Any:
    """The spec tree matching ``params_tree`` (of tensors, meta or real).
    The structural leading axes come first: the client axis (when
    ``plan.n_clients > 1``, over ``plan.client_axes``) and the period-stack
    axis (paths under ``period/``, whole)."""
    client_spec = plan.client_axes if plan.client_axes else None

    def one(path, leaf):
        shape = tuple(leaf.shape)
        lead: List[Entry] = []
        if plan.n_clients > 1:
            lead.append(client_spec)
            shape = shape[1:]
        if "period/" in path:
            lead.append(None)       # period-stack axis
            shape = shape[1:]
        return tuple(lead) + _param_spec(cfg, mesh, plan, path, shape)

    return map_with_path(one, params_tree)


# ---------------------------------------------------------------------------
# Batch / decode-state specs
# ---------------------------------------------------------------------------


def train_batch_pspecs(cfg: ModelConfig, plan: ShardingPlan,
                       batch_tree: Any) -> Any:
    """[C, m, ...] or [B, ...]: client axis per plan, batch dim per plan."""

    def one(leaf):
        nd = len(leaf.shape)
        if plan.n_clients > 1:
            lead = (plan.client_axes if plan.client_axes else None,
                    plan.batch_axes if plan.batch_axes else None)
        else:
            lead = (plan.batch_axes if plan.batch_axes else None,)
        return lead + (None,) * (nd - len(lead))

    return tree_map(one, batch_tree)


def serve_batch_pspecs(plan: ShardingPlan, batch_tree: Any) -> Any:
    def one(leaf):
        nd = len(leaf.shape)
        return ((plan.batch_axes if plan.batch_axes else None,)
                + (None,) * (nd - 1))

    return tree_map(one, batch_tree)


def _seq_ok(seq: Entry, dim: int, mesh) -> Entry:
    if seq is None:
        return None
    return seq if dim % _extent(mesh, seq) == 0 else None


def decode_state_pspecs(cfg: ModelConfig, mesh, plan: ShardingPlan,
                        state_tree: Any) -> Any:
    """Decode caches: [n_per?, B, S, ...] for attention kv; recurrent
    states [n_per?, B, ...]. The sequence axis is sharded per
    ``plan.seq_axes`` (sequence-parallel decode: each rank attends over its
    block of positions, and the partial softmaxes combine exactly)."""
    batch = plan.batch_axes if plan.batch_axes else None
    seq = plan.seq_axes if plan.seq_axes else None

    def one(path, leaf):
        shape = tuple(leaf.shape)
        lead: List[Entry] = []
        if "period/" in path:
            lead = [None]
            shape = shape[1:]
        name = path.split("/")[-1]
        if name in ("k", "v"):          # [B, S, Hkv, hd]
            inner = (batch, _seq_ok(seq, shape[1], mesh), None, None)
        elif name in ("ckv", "k_rope"):  # [B, S, d]
            inner = (batch, _seq_ok(seq, shape[1], mesh), None)
        elif name == "conv":            # [B, W-1, d_in]
            inner = (batch, None, _div(shape[2], mesh, plan.model_axes))
        elif name == "h" and len(shape) == 3:   # ssm [B, d_in, ds]
            inner = (batch, _div(shape[1], mesh, plan.model_axes), None)
        elif name == "C":               # mlstm [B, H, hd, hd]
            inner = (batch, _div(shape[1], mesh, plan.model_axes), None,
                     None)
        elif name in ("n", "m", "c", "h"):
            hdiv = (_div(shape[1], mesh, plan.model_axes)
                    if len(shape) > 1 else None)
            inner = (batch,) + ((hdiv,) + (None,) * (len(shape) - 2)
                                if len(shape) > 1 else ())
        else:
            inner = (batch,) + (None,) * (len(shape) - 1)
        return tuple(lead) + tuple(inner)

    return map_with_path(one, state_tree)


# ---------------------------------------------------------------------------
# A rank's blocks
# ---------------------------------------------------------------------------


def split_entry(entry: Entry, mesh) -> Entry:
    """``entry`` less its axes of extent 1 (None when nothing splits)."""
    if not entry:
        return None
    extents = dict(mesh.axes)
    kept = tuple(a for a in entry if extents[a] > 1)
    return kept or None


def block_index(entry: Entry, mesh, coord=None) -> int:
    """The block of a dim split over ``entry`` that the rank at
    ``coord`` (axis -> coordinate; default ``mesh.coord``) holds:
    row-major over the entry's coordinates, in the order named."""
    if not entry:
        return 0
    coord = coord or mesh.coord
    extents = dict(mesh.axes)
    return int(np.ravel_multi_index([coord(a) for a in entry],
                                    [extents[a] for a in entry]))


def _block(x: torch.Tensor, dim: int, entry: Entry, mesh,
           coord=None) -> torch.Tensor:
    n = _extent(mesh, entry) if entry else 1
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks over {entry}")
    size = x.shape[dim] // n
    return x.narrow(dim, block_index(entry, mesh, coord) * size, size)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh, coord=None
               ) -> torch.Tensor:
    """The block of ``x`` under ``spec`` that the mesh's rank holds (a
    view)."""
    if len(spec) != x.dim():
        raise ValueError(f"a spec of {len(spec)} entries for a leaf of "
                         f"shape {tuple(x.shape)}")
    for d, entry in enumerate(spec):
        x = _block(x, d, entry, mesh, coord)
    return x


def shard_tree(full: Any, specs: Any, mesh) -> Any:
    """The rank's block of every leaf of ``full`` under ``specs`` (views;
    ``mesh.rank`` names the rank)."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), full, specs)


def gather_tree(blocks: Sequence[Any], specs: Any, mesh) -> Any:
    """The full tree from every rank's blocks (``blocks[r]``: rank r's
    tree of tensors, ranks row-major over the mesh's axes), on the host.
    Each full leaf takes each block at its place; replicas of a block
    must agree (else ``ValueError``)."""
    coords = [dict(zip(mesh.axis_names, np.unravel_index(r, mesh.shape)))
              for r in range(len(blocks))]

    def one(first, spec, *rest):
        parts = (first,) + rest
        parts = [p.detach().cpu() for p in parts]
        shape = [n * (_extent(mesh, e) if e else 1)
                 for n, e in zip(parts[0].shape, spec)]
        out = torch.empty(shape, dtype=parts[0].dtype)
        seen = torch.zeros(shape, dtype=torch.bool)
        for part, c in zip(parts, coords):
            view, mask = out, seen
            for d, entry in enumerate(spec):
                view = _block(view, d, entry, mesh, c.__getitem__)
                mask = _block(mask, d, entry, mesh, c.__getitem__)
            if bool(mask.all()) and not torch.equal(view, part):
                raise ValueError("replicas of one block differ")
            view.copy_(part)
            mask.fill_(True)
        return out

    return tree_map(one, blocks[0], specs, *blocks[1:])


def relayout(x: torch.Tensor, src: Spec, dst: Spec, mesh) -> torch.Tensor:
    """The rank's block of a leaf under ``dst`` from its block under
    ``src``: each dim whose split differs is gathered over its ``src``
    axes (a collective where the rank lacks the block), then cut to its
    ``dst`` block (a slice where it already holds it); every gather comes
    before any cut, so each gathers blocks of the same span of the other
    dims. ``mesh`` is a ``launch.mesh.ClientMesh``."""
    moves = [(d, split_entry(a, mesh), split_entry(b, mesh))
             for d, (a, b) in enumerate(zip(src, dst))]
    moves = [(d, a, b) for d, a, b in moves if a != b]
    for d, a, _ in moves:
        if a:   # eager torch's gather, materialized (RL302 is XLA's)
            # repro-lint: disable=RL302
            x = mesh.all_gather(x, a, dim=d)
    for d, _, b in moves:
        x = _block(x, d, b, mesh)
    return x.contiguous()

