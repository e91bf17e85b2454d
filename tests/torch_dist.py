"""Rank-side helpers of the port's client-sharded tests (not a test module).

``launch.mesh.run_world`` pickles the function each rank runs by its
import path, so the functions the tests hand it live here, where a spawned
rank can import them (the tests' directory is on its ``sys.path``). Each
takes numpy inputs made by the test process and returns host values: the
final params as numpy, the history, the ledger's header hashes and whether
the chain validates. Nothing here imports JAX.
"""
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
