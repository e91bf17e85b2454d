"""Rank-side helpers of the port's client-sharded tests (not a test module).

``launch.mesh.run_world`` pickles the function each rank runs by its
import path, so the functions the tests hand it live here, where a spawned
rank can import them (the tests' directory is on its ``sys.path``). Each
takes numpy inputs made by the test process and returns host values: the
final params as numpy, the history, the ledger's header hashes and whether
the chain validates. Nothing here imports JAX.
"""
import contextlib
import functools

import numpy as np
import torch

from repro_torch.core import aggregation, mining, rounds, topology
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.mlp import init_mlp, mlp_client_losses
from repro_torch.sharding import plans

HIDDEN, M = 32, 16


def mlp_inputs(c, seed=0):
    """MLP params (hidden 32) and a ``[C, 16]`` batch, as numpy, from a
    seed: the port's init and a numpy generator's data."""
    params = {k: v.numpy() for k, v in
              init_mlp(torch.Generator().manual_seed(seed),
                       hidden=HIDDEN).items()}
    rng = np.random.default_rng(seed)
    batch = {"x": rng.uniform(0, 1, (c, M, 784)).astype(np.float32),
             "y": rng.integers(0, 10, (c, M)).astype(np.int64)}
    return params, batch


def _tensors(tree):
    """numpy leaves as tensors: floats as they are, integers as int64."""
    out = {}
    for k, v in tree.items():
        v = np.ascontiguousarray(v)
        if np.issubdtype(v.dtype, np.integer):
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(v.copy())
    return out


def host_run(state, hist, ledger):
    """A run's (params as numpy, history, header hashes, chain valid)."""
    return ({k: v.detach().cpu().numpy() for k, v in state.params.items()},
            hist, [b.header_hash for b in ledger.blocks],
            ledger.validate_chain())


def run_mlp(spec, params, batch, k, mesh=None, stacked=False, seed=3,
            **kw):
    """``rounds.run_blade_fl`` of ``spec`` on numpy ``params`` and
    ``batch`` (the whole ``[C, ...]`` batch, or ``[K, C, ...]`` when
    ``stacked``) on the CPU; on a mesh the rank's rows of the batch."""
    batch = _tensors(batch)
    if mesh is not None:
        rows = plans.block_rows(spec.n_clients, mesh.n_shards,
                                mesh.shard_index)
        batch = {n: (v[:, rows] if stacked else v[rows])
                 for n, v in batch.items()}
    out = rounds.run_blade_fl(mlp_client_losses, spec, _tensors(params),
                              batch, k, seed=seed, device="cpu",
                              stacked=stacked, mesh=mesh, **kw)
    return host_run(*out)


def mesh_of(layout):
    """The mesh of ``layout``: ``("data", D)`` or ``("cluster", G)``."""
    kind, n = layout
    world = torch.distributed.get_world_size()
    if kind == "cluster":
        return mesh_lib.make_cluster_mesh(n, world, "cpu")
    return mesh_lib.make_client_mesh(world, "cpu")


def runs_rank(jobs):
    """Each job ``(name, layout, spec, params, batch, k, kw)`` run on its
    mesh; returns {name: host run}."""
    meshes = {}
    out = {}
    for name, layout, spec, params, batch, k, kw in jobs:
        if layout not in meshes:
            meshes[layout] = mesh_of(layout)
        out[name] = run_mlp(spec, params, batch, k, meshes[layout], **kw)
    return out


def cohort_rank(spec, params, enrolled, k, seed, samples):
    """The cohort driver over this rank's block of each cohort; returns
    the history, the header hashes, the chain's validity and the store's
    rows of the last cohort."""
    from repro_torch.data.pipeline import CohortDataSource

    mesh = mesh_lib.make_client_mesh(0, "cpu")
    src = CohortDataSource(seed, samples, device="cpu")
    cohort = topology.CohortSchedule.from_spec(enrolled, spec.n_clients,
                                               "uniform")
    store, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, spec, _tensors(params), src.cohort_batch, k,
        cohort, seed=seed, device="cpu", mesh=mesh)
    last = store.gather(hist[-1]["cohort"])
    return (hist, [b.header_hash for b in ledger.blocks],
            ledger.validate_chain(), {n: v.numpy() for n, v in last.items()},
            store.touched)


def mixes_rank(cases):
    """Each case ``(name, layout, fn_name, tree, kwargs)``: the mix
    ``aggregation.<fn_name>`` (or ``mining.digest_tree``) on this rank's
    rows of ``tree`` with the mesh; returns {name: the gathered result
    (a dict of numpy leaves, or a 0-d value)}."""
    meshes = {}
    out = {}
    for name, layout, fn_name, tree, kw in cases:
        if layout not in meshes:
            meshes[layout] = mesh_of(layout)
        mesh = meshes[layout]
        local = aggregation.client_local_rows(_tensors(tree), mesh)
        kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in kw.items()}
        if fn_name == "digest_tree":
            res = mining.digest_tree(local, mesh)
        elif fn_name == "client_divergence_psum":
            res = aggregation.client_divergence_psum(local, mesh)
        else:
            fn = getattr(aggregation, fn_name)
            res = aggregation.client_all_gather(fn(local, mesh=mesh, **kw),
                                                mesh)
        out[name] = ({k: v.numpy() for k, v in res.items()}
                     if isinstance(res, dict) else res.numpy())
    return out


@contextlib.contextmanager
def mla_absorbed(on):
    """MLA's full-sequence forward in its absorbed form (the reference's
    ``REPRO_MLA_ABSORBED`` ablation) while ``on``."""
    from repro_torch.models import attention

    forward = attention.mla_forward
    if on:
        attention.mla_forward = functools.partial(forward, absorbed=True)
    try:
        yield
    finally:
        attention.mla_forward = forward


def serve_mesh_rank(cases):
    """Each case (name -> dict of ``cfg``, ``mesh`` (data, model),
    ``params`` (numpy tree), ``dtype`` (the params cast to it),
    ``tokens`` [B, prompt + n] numpy, ``n``, ``plan``, ``decode_plan``,
    ``max_len``, optionally ``absorbed``: MLA's prefill in its absorbed
    form, and ``batch``: the prefill's batch (numpy; a VLM's patches and
    text, the audio encoder's frames and mask positions), ``tokens`` then
    the ``n`` decode tokens [B, n]) served on this rank's mesh by
    ``launch.serve.serve_on_mesh``; returns {name: this rank's logits
    blocks (numpy fp32, one a position), state blocks (numpy fp32 tree),
    their specs and the bytes received}."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import serve
    from repro_torch.weights import lm_params_from_jax

    meshes, out = {}, {}
    for name, case in cases.items():
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = mesh_lib.make_host_mesh(shape, ("data", "model"),
                                                    "cpu")
        tokens = torch.from_numpy(case["tokens"].astype(np.int64))
        if "batch" in case:
            batch = _tensors(case["batch"])
        else:
            prompt = tokens.shape[1] - case["n"]
            batch, tokens = {"tokens": tokens[:, :prompt]}, tokens[:, prompt:]
        params = tree_lib.tree_map(
            lambda x: x.to(case["dtype"]),
            lm_params_from_jax(case["params"], "cpu"))
        with mla_absorbed(case.get("absorbed", False)):
            res = serve.serve_on_mesh(
                case["cfg"], params, batch, tokens, meshes[shape], case["plan"],
                case["decode_plan"], case["max_len"])
        out[name] = {
            "logits": [x.float().numpy() for x in res["logits"]],
            "state": tree_lib.tree_map(lambda x: x.float().numpy(),
                                       res["state"]),
            "logits_spec": res["logits_spec"],
            "state_specs": res["state_specs"],
            "received": res["received"]}
    for shape, mesh in meshes.items():   # block orders of the collectives
        x = torch.tensor([[float(mesh.rank)]])
        out[f"gathers {shape}"] = {
            axes: (mesh.all_gather(x, axes, dim=1).numpy(),
                   mesh.all_reduce(x, axes).numpy(), mesh.index(axes))
            for axes in ("data", "model", ("data", "model"))}
        try:   # raises before any rank joins a collective
            mesh.all_gather(x, ("model", "data"))
            out[f"out of order {shape}"] = None
        except ValueError as e:
            out[f"out of order {shape}"] = str(e)
    return out


def train_mesh_rank(jobs):
    """Each job (name -> dict) on this rank's ``("data", "model")`` mesh
    of ``job["mesh"]``, through ``steps.build_train_step`` under
    ``job["plan"]`` (and ``job["spec"]`` as its ``spec_override``):

    ``"grad"``    the step's per-client loss on this rank's blocks of the
                  round-0 state of ``params`` (one model, numpy, flattened)
                  and ``tokens`` [C, m, S] (or ``batch``: a train batch of
                  [C, m, ...] leaves, numpy), and its gradient a leaf;
    ``"rounds"``  ``len(tokens)`` rounds of the step from that state on
                  ``tokens`` [K, C, m, S] (or ``batch`` of [K, C, m, ...]
                  leaves), each round's noise ``noise[k]``
                  (full shapes) or, with None, the step's own draws from
                  the generator seeded with ``seed``, and the mixing
                  matrix ``matrices[k]`` when given;
    ``"stage"``   the communicate stage (``rounds.make_communicate`` on
                  the data axis' view, the model blocks of ``params`` [C,
                  ...] a leaf) on this rank's blocks.

    Returns {name: this rank's blocks (numpy) with their specs, and the
    per-round metrics, the bytes received by op and axes}."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.sharding import specs

    meshes, out = {}, {}
    for name, job in jobs.items():
        if job["mesh"] not in meshes:
            meshes[job["mesh"]] = mesh_lib.make_host_mesh(
                job["mesh"], ("data", "model"), "cpu")
        mesh = meshes[job["mesh"]]
        cfg, plan = job["cfg"], job["plan"]
        batches = job.get("batch") or {"tokens": job["tokens"]}
        lead = 1 if job["kind"] == "rounds" else 0
        c, m = next(iter(batches.values())).shape[lead:lead + 2]
        step, _, _, _ = steps.build_train_step(
            cfg, ShapeConfig("mesh_train", train_seq(cfg, batches, lead),
                             c * m, "train"), mesh, False,
            torch.float32, spec_override=job.get("spec"), plan=plan)
        pspecs = step.in_specs[0].params
        if job["kind"] == "stage":
            out[name] = _stage_on_blocks(job, mesh, pspecs)
            continue
        state = step.init_state(_tensors(job["params"]), job.get("seed", 0))
        mesh.received_by_axes.clear()
        if job["kind"] == "grad":
            batch = specs.shard_tree(_tensors(batches), step.in_specs[1],
                                     mesh)
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in state.params.items()}
            keys = sorted(leaves)
            losses = step.loss_fn(leaves, batch)
            grads = torch.autograd.grad(losses.sum(),
                                        [leaves[k] for k in keys],
                                        materialize_grads=True)
            out[name] = {"losses": losses.detach().numpy(),
                         "grads": {k: g.numpy() for k, g in zip(keys, grads)},
                         "specs": pspecs}
            continue
        metrics = []
        for k in range(len(next(iter(batches.values())))):
            batch = specs.shard_tree(
                _tensors({n: v[k] for n, v in batches.items()}),
                step.in_specs[1], mesh)
            noise = job["noise"][k] if job.get("noise") else None
            if noise is not None:
                noise = {stage: _tensors(v) for stage, v in noise.items()}
            matrix = (torch.from_numpy(job["matrices"][k])
                      if job.get("matrices") is not None else None)
            state, mets = step(state, batch, matrix, noise=noise)
            metrics.append({n: v.numpy() for n, v in mets.items()})
        out[name] = {"params": {k: v.numpy()
                                for k, v in state.params.items()},
                     "metrics": metrics, "specs": pspecs,
                     "received": dict(mesh.received_by_axes)}
    return out


def train_seq(cfg, batch, lead=0):
    """The positions S of a train batch's rows (``registry
    .make_train_batch``'s layout; ``lead`` dims before [C, m, ...])."""
    if cfg.audio_frontend:
        return batch["frames"].shape[lead + 2]
    if cfg.family == "vlm":
        return batch["patches"].shape[lead + 2] \
            + batch["tokens"].shape[lead + 2]
    return batch["tokens"].shape[lead + 2]


def _stage_on_blocks(job, mesh, pspecs):
    """The communicate stage of ``job["spec"]`` and of each of
    ``job["more_specs"]`` on this rank's blocks of ``job["params"]`` ([C,
    ...] leaves, numpy): its blocks of the mixed params, the digest, the
    divergence (and each further spec's mixed blocks)."""
    from repro_torch.sharding import specs

    split = {k for k, spec in pspecs.items()
             if any(e and "model" in e for e in spec[1:])}
    model = aggregation.ModelBlocks(mesh.view("model"),
                                    {k: ("model",) for k in split})
    local = {k: specs.shard_leaf(v, pspecs[k], mesh).contiguous()
             for k, v in _tensors(job["params"]).items()}
    out = {"specs": pspecs}
    for i, spec in enumerate([job["spec"]] + job.get("more_specs", [])):
        communicate = rounds.make_communicate(spec, "cpu",
                                              mesh.view("data"), model)
        mixed, digest, divergence, _ = communicate(local, local, 0)
        mixed = {k: v.numpy() for k, v in mixed.items()}
        if i:
            out.setdefault("more_params", []).append(mixed)
        else:
            out.update(params=mixed, digest=int(digest),
                       divergence=float(divergence))
    return out


def train_fsdp_rank(jobs):
    """Each job (name -> dict) on this rank's ``("data", "model")`` mesh
    of ``job["mesh"]``, through ``steps.build_train_step`` under the L2
    plan ``job["plan"]`` and the round spec ``job["spec"]``:

    ``"grad"``    ``step.grad_fn`` at the round-0 state of ``params`` (one
                  model, numpy, flattened) on ``tokens`` [C, m, S]: the
                  per-client losses and this rank's block of every
                  gradient over the spec's microbatches; with
                  ``job["witness"]`` also the losses of the two faults
                  the layout guards against: the microbatches cut from
                  the rank's contiguous block (no re-cut) and each rank's
                  own MoE load-balance loss (``batch_loss`` off in
                  ``moe.moe_apply``);
    ``"rounds"``  ``len(tokens)`` rounds of the step on ``tokens`` [K, C,
                  m, S], each round's noise ``noise[k]`` (full shapes) or
                  the step's own draws from the generator seeded with
                  ``seed``;
    ``"reduce_scatter"``  ``ClientMesh.reduce_scatter`` of
                  :func:`rank_tensor` (:func:`_reduce_scatters`).

    Returns {name: this rank's blocks (numpy) with their specs, the
    per-round metrics and the bytes received by op and axes}."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.sharding import specs

    meshes, out = {}, {}
    for name, job in jobs.items():
        if job["mesh"] not in meshes:
            meshes[job["mesh"]] = mesh_lib.make_host_mesh(
                job["mesh"], ("data", "model"), "cpu")
        mesh = meshes[job["mesh"]]
        if job["kind"] == "reduce_scatter":
            out[name] = _reduce_scatters(mesh)
            continue
        toks = job["tokens"]
        c, m, s = toks.shape[-3:]
        step, _, _, spec = steps.build_train_step(
            job["cfg"], ShapeConfig("fsdp_train", s, c * m, "train"), mesh,
            False, torch.float32, spec_override=job["spec"],
            plan=job["plan"])
        pspecs = step.in_specs[0].params
        state = step.init_state(_tensors(job["params"]), job.get("seed", 0))
        mesh.received_by_axes.clear()
        if job["kind"] == "grad":
            batch = specs.shard_tree(_tensors({"tokens": toks}),
                                     step.in_specs[1], mesh)
            losses, grads = step.grad_fn(state.params, batch)
            res = {"losses": losses.numpy(),
                   "grads": {k: g.numpy()
                             for k, g in zip(sorted(state.params), grads)},
                   "specs": pspecs, "received": dict(mesh.received_by_axes)}
            if job.get("witness"):
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in state.params.items()}
                res["contiguous"] = rounds.make_grad(step.loss_fn, spec)(
                    leaves, batch)[0].numpy()
                apply = moe.moe_apply

                def own_aux(p, cfg, x, drops=None, par=None):
                    return apply(p, cfg, x, drops, par and dataclasses
                                 .replace(par, batch_loss=False))

                moe.moe_apply = own_aux
                try:
                    res["own_aux"] = step.grad_fn(state.params,
                                                  batch)[0].numpy()
                finally:
                    moe.moe_apply = apply
            out[name] = res
            continue
        metrics = []
        for k in range(len(toks)):
            batch = specs.shard_tree(_tensors({"tokens": toks[k]}),
                                     step.in_specs[1], mesh)
            noise = job["noise"][k] if job.get("noise") else None
            if noise is not None:
                noise = {st: _tensors(v) for st, v in noise.items()}
            state, mets = step(state, batch, noise=noise)
            metrics.append({n: v.numpy() for n, v in mets.items()})
        out[name] = {"params": {k: v.numpy()
                                for k, v in state.params.items()},
                     "metrics": metrics, "specs": pspecs,
                     "received": dict(mesh.received_by_axes)}
    return out


def rank_tensor(rank):
    """A [4, 6] float tensor of integers, another on every rank (sums
    exact in fp32)."""
    return torch.arange(24, dtype=torch.float32).reshape(4, 6) \
        * (rank + 1) + 100 * rank


def _reduce_scatters(mesh):
    """{(axes, dim): (this rank's block, bytes received)} of
    ``mesh.reduce_scatter(rank_tensor(rank), axes, dim)`` over data,
    model and (data, model), along dims 0 and 1 (those that split)."""
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        for dim in (0, 1):
            if rank_tensor(0).shape[dim] % mesh.extent(axes):
                continue
            mesh.received_by_axes.clear()
            block = mesh.reduce_scatter(rank_tensor(mesh.rank), axes, dim)
            out[(axes, dim)] = (block.numpy(),
                                mesh.received["reduce_scatter"])
    return out
