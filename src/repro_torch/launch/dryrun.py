"""The dry-run on meta tensors (the JAX package's ``launch/dryrun.py``):
prove that every (architecture x input shape x production mesh) triple
builds and runs on one rank of the production meshes, and count its
roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each step for 256 (``pod16x16``: data
16 x model 16) or 512 (``pod2x16x16``: pod 2 x data 16 x model 16) TPU
placeholders and parses the compiled HLO. Here one process plays one rank
(``--rank``, default 0) of such a mesh: a :class:`DryMesh` (a
``launch.mesh.ClientMesh`` with no process group, whose collectives give
outputs of their shapes on the input's device and count their bytes as a
rank's do), the step built by ``launch.steps.build_step`` on it, the
rank's blocks drawn as meta tensors (``registry.params_specs`` cut by
``specs.shard_tree``), and the step run once on them under
``launch.cost_analysis.CostCounter``. Meta tensors carry shapes and
dtypes and no data: the models run every op, the kernels' wrappers
allocate their outputs and report their costs, and nothing is computed or
drawn.

Each pair's record (``<out-dir>/<arch>__<shape>__<mesh>.json``) has the
reference's keys where they mean something here: ``arch``, ``shape``,
``mesh``, ``kind``, ``status`` (``ok``, ``skipped`` with ``reason``, or
``failed`` with ``error`` and ``traceback``), ``plan``, ``model_flops``,
``useful_flops_ratio`` (model flops over the ranks' counted flops),
``active_params``, ``total_params``; ``trace_s`` (the build and the run on
meta tensors) in place of ``lower_s`` and ``compile_s``; ``memory``
(``argument_bytes`` and ``output_bytes``, the rank's blocks in and out,
and ``peak_live_bytes``, the largest sum of live storages the counter
saw); ``cost`` (``CostCounter``'s counts: flops, HBM bytes, the bytes the
rank receives by collective, the attention's masked flops) in place of
``hlo_parsed``; and ``roofline`` (``launch.analysis.roofline`` on the
rank's costs). The serve steps run in bf16, as the reference's do, and
are priced at the H100's bf16 peak; the train step runs in fp32, the only
dtype the port trains in (flash's backward kernel takes fp32 alone), and
is priced at its fp32 peak (``dtype`` in the record). ``--out-dir``
defaults to
``build/dryrun/``. Exits 1 when a pair failed, as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import INPUT_SHAPES, arch_ids, get_arch, get_shape
from repro_torch.launch import analysis, cost_analysis, steps
from repro_torch.launch.mesh import Axes, ClientMesh
from repro_torch.sharding import specs as specs_lib

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
OUT_DIR = os.path.join(ROOT, "build", "dryrun")
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ROUND_TAU = 2   # steps.round_spec_for's default local iterations
# the steps' dtypes: serving in bf16, as the reference's build_step
# default; training in fp32, the only dtype the port trains in (flash's
# backward kernel takes fp32 alone)
STEP_DTYPES = {"train": torch.float32, "prefill": torch.bfloat16,
               "decode": torch.bfloat16}


@dataclasses.dataclass(eq=False)
class DryMesh(ClientMesh):
    """One rank of a mesh of any extents with no process group. Its
    collectives dispatch the ops a rank's do, less the backend's call, and
    count their received bytes exactly as a rank does
    (``ClientMesh._count``): ``all_gather`` returns a tensor of the
    gathered shape, ``all_reduce`` a copy of its input, ``shift`` a
    tensor of the block's shape for each step (the block itself where it
    lands on this rank), and the inherited ``reduce_scatter`` its ring of
    shifts. At an extent of 1 every result is exact; past it only the
    shapes are. Build it with :meth:`make`."""

    @classmethod
    def make(cls, shape: Sequence[int], axes: Sequence[str], rank: int = 0,
             device="meta") -> "DryMesh":
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "match")
        n = 1
        for e in shape:
            n *= e
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        return cls(axis_names=axes, shape=shape, rank=int(rank),
                   backend="none", device=torch.device(device), world=None,
                   groups={})

    def _group(self, axes):
        return None

    def all_gather(self, x: torch.Tensor, axis: Axes = None,
                   dim: int = 0) -> torch.Tensor:
        axes = self._axes(axis)
        if axes != tuple(a for a in self.axis_names if a in axes):
            raise ValueError(f"all_gather over {axes}: name the axes in the "
                             f"mesh's order {self.axis_names}")
        n = self.extent(axes)
        dim = dim % x.dim()
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        if n == 1:
            out.copy_(x)
        self._count("all_gather", (n - 1) * x.numel() * x.element_size(),
                    axes)
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor, axis: Axes = None
                   ) -> torch.Tensor:
        axes = self._axes(axis)
        out = x.contiguous().clone()
        n = self.extent(axes)
        self._count("all_reduce", 2 * (n - 1) / n * out.numel()
                    * out.element_size(), axes)
        return out

    def _exchange(self, x: torch.Tensor, steps_: Sequence[int],
                  axis: Optional[str], op: str) -> List[torch.Tensor]:
        x = x.contiguous()
        out = []
        for q in steps_:
            if self._peer(axis, q) == self.rank:
                out.append(x)
                continue
            out.append(torch.empty(x.shape, dtype=x.dtype, device=x.device))
            self._count(op, x.numel() * x.element_size(), self._axes(axis))
        return out


def production_mesh(multi_pod: bool, rank: int = 0) -> DryMesh:
    """Rank ``rank`` of ``pod16x16`` or, with ``multi_pod``,
    ``pod2x16x16`` (the reference's ``make_production_mesh``), on meta
    tensors."""
    shape, axes = MESHES["pod2x16x16" if multi_pod else "pod16x16"]
    return DryMesh.make(shape, axes, rank)


def _nbytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def rank_inputs(kind: str, step, abs_in, mesh, shape) -> tuple:
    """This rank's inputs of a step built by ``steps.build_step``, as meta
    tensors (``step.in_specs`` cut from the abstract inputs): prefill
    (params, batch); decode (params, state, token, pos) at the cache's
    last position ``pos = shape.seq_len - 1``; train (the round-0 state
    ``step.init_state`` makes of the whole model, batch)."""
    if kind == "train":
        state_abs, batch_abs = abs_in
        whole = {k: torch.empty(v.shape[1:], dtype=v.dtype,
                                device=mesh.device)
                 for k, v in state_abs.params.items()}
        state = step.init_state(whole, 0)
        return state, specs_lib.shard_tree(batch_abs, step.in_specs[1],
                                           mesh)
    blocks = [specs_lib.shard_tree(x, spec, mesh)
              for x, spec in zip(abs_in, step.in_specs)
              if isinstance(x, (dict, torch.Tensor))]
    if kind == "prefill":
        return tuple(blocks)
    params, state, token = blocks
    return params, state, token, shape.seq_len - 1


@dataclasses.dataclass
class Traced:
    """One traced step: the step, its plan, the rank's inputs, its output
    and the costs the counter read."""
    step: object
    plan: object
    inputs: tuple
    out: object
    costs: cost_analysis.Costs


def trace(kind: str, cfg, shape, mesh, multi_pod: bool = False,
          dtype=torch.bfloat16, inputs: Optional[tuple] = None,
          plan=None) -> Traced:
    """Build the ``kind`` step of ``cfg`` x ``shape`` on ``mesh`` (under
    ``plan``, default the reference's plan for the arch) and run it once
    under a ``CostCounter``. ``inputs`` (default: this rank's blocks as
    meta tensors, :func:`rank_inputs`) replaces the inputs, for a run on
    real tensors."""
    if kind == "train":
        step, abs_in, plan, _ = steps.build_train_step(
            cfg, shape, mesh, multi_pod, dtype, plan=plan)
    else:
        build = (steps.build_prefill_step if kind == "prefill"
                 else steps.build_decode_step)
        step, abs_in, plan = build(cfg, shape, mesh, multi_pod, dtype,
                                   plan=plan)
    if inputs is None:
        inputs = rank_inputs(kind, step, abs_in, mesh, shape)
    mesh.received_by_axes.clear()
    with cost_analysis.CostCounter() as counter:
        counter.live(inputs)
        out = step(*inputs)
    return Traced(step, plan, inputs, out, counter.costs)


def model_flops(cfg, shape) -> float:
    """The reference's MODEL_FLOPS: 6·N·D·tau for a training round (tau
    2, D = the batch's next-token targets), 2·N·D for a prefill, 2·N·B
    for a decode step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return analysis.model_flops(
            n, shape.global_batch * (shape.seq_len - 1), True, ROUND_TAU)
    if shape.kind == "prefill":
        return analysis.model_flops(n, shape.global_batch * shape.seq_len,
                                    False)
    return analysis.model_flops(n, shape.global_batch, False)


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             rank: int = 0) -> dict:
    """The record of one (arch, shape, mesh) triple at rank ``rank``."""
    cfg0 = get_arch(arch)
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok", "rank": rank}
    reason = steps.skip_reason(cfg0, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    cfg = steps.resolve_cfg(cfg0, shape)
    mesh = production_mesh(multi_pod, rank)
    chips = mesh.n_shards
    dtype = STEP_DTYPES[shape.kind]
    rec["dtype"] = str(dtype).replace("torch.", "")
    t0 = time.perf_counter()
    traced = trace(shape.kind, cfg0, shape, mesh, multi_pod, dtype)
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    plan, costs = traced.plan, traced.costs
    rec["plan"] = {
        "n_clients": plan.n_clients, "client_axes": list(plan.client_axes),
        "batch_axes": list(plan.batch_axes),
        "fsdp_axes": list(plan.fsdp_axes), "seq_axes": list(plan.seq_axes)}
    rec["memory"] = {"argument_bytes": _nbytes(traced.inputs),
                     "output_bytes": _nbytes(traced.out),
                     "peak_live_bytes": costs.peak_live_bytes}
    rec["cost"] = costs.as_dict()
    rec["roofline"] = analysis.roofline(
        costs.flops, costs.hbm_bytes, costs.collective_bytes, chips,
        peak_flops=(analysis.PEAK_FLOPS_FP32 if dtype == torch.float32
                    else analysis.PEAK_FLOPS_BF16))
    mf = model_flops(cfg, shape)
    rec["model_flops"] = mf
    total = costs.flops * chips
    rec["useful_flops_ratio"] = mf / total if total else None
    rec["active_params"] = cfg.active_param_count()
    rec["total_params"] = cfg.param_count()
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh this process plays")
    ap.add_argument("--out-dir", default=OUT_DIR)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    archs = arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_skip = n_fail = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                path = os.path.join(args.out_dir,
                                    f"{a}__{s}__{mesh_name}.json")
                print(f"[running] {a} x {s} x {mesh_name} ...", flush=True)
                try:
                    rec = run_pair(a, s, mp, args.rank)
                except Exception as e:   # a failed pair is a record
                    rec = {"arch": a, "shape": s, "mesh": mesh_name,
                           "status": "failed", "rank": args.rank,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"  ok trace={rec['trace_s']}s dominant="
                          f"{r['dominant']} bound={r['bound_s']:.4g}s "
                          f"useful={rec['useful_flops_ratio']}", flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"  skipped: {rec['reason']}", flush=True)
                else:
                    n_fail += 1
                    print(f"  FAILED: {rec['error']}", flush=True)
    print(f"\nsummary: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
