"""The port's placement layer against the JAX package's, with no ranks.

For all ten archs at their full configs, the four ``INPUT_SHAPES`` and
both production meshes (16 x 16 ``("data", "model")`` and 2 x 16 x 16
``("pod", "data", "model")``): ``train_plan`` / ``serve_plan`` field by
field, ``batch_divisible``, the spec trees of ``param_pspecs``,
``train_batch_pspecs``, ``serve_batch_pspecs`` and ``decode_state_pspecs``
leaf by leaf (the reference's entries read as ``str -> (str,)``, a tuple
as it is, ``None`` as it is), and the five abstract-shape helpers' shapes
and dtypes. The reference builds its specs on ``make_fake_mesh``, the
port on ``specs.MeshShape``. Then ``shard_tree`` / ``gather_tree`` round
trips on dims split over several axes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from conftest import make_fake_mesh
from repro.configs import INPUT_SHAPES, arch_ids
from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.sharding import plans as jplans
from repro.sharding import specs as jspecs
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.sharding import plans, specs

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

MESHES = {"single": ((16, 16), ("data", "model"), False),
          "multi": ((2, 16, 16), ("pod", "data", "model"), True)}
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.int32: torch.int32, jnp.bool_: torch.bool}


def _entry(e):
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


def _ref_specs(tree_):
    """The reference's spec tree as {path: tuple of entries}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: isinstance(x, P))
    return {jspecs._path_str(p): tuple(_entry(e) for e in s)
            for p, s in flat}


def _ref_shapes(tree_):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_)
    return {jspecs._path_str(p): (tuple(x.shape), DTYPES[x.dtype.type])
            for p, x in flat}


def _shapes(tree_):
    return {k: (tuple(v.shape), v.dtype)
            for k, v in tree.flatten(tree_).items()}


@functools.lru_cache(maxsize=None)
def _ref_params(arch, n_clients):
    return jregistry.params_specs(jget_arch(arch), jnp.bfloat16,
                                  n_clients=n_clients)


@functools.lru_cache(maxsize=None)
def _params(arch, n_clients):
    return registry.params_specs(get_arch(arch), torch.bfloat16,
                                 n_clients=n_clients)


def _plans(arch, mesh_name):
    """{shape name: (reference plan, port plan)} on one production mesh."""
    shape, axes, multi = MESHES[mesh_name]
    jmesh, mesh = make_fake_mesh(shape, axes), specs.MeshShape(axes, shape)
    out = {}
    for name, sh in INPUT_SHAPES.items():
        if sh.kind == "train":
            out[name] = (jplans.train_plan(jget_arch(arch), sh, jmesh, multi),
                         plans.train_plan(get_arch(arch), sh, mesh, multi))
        else:
            out[name] = (jplans.serve_plan(jget_arch(arch), sh, jmesh, multi),
                         plans.serve_plan(get_arch(arch), sh, mesh, multi))
    return jmesh, mesh, out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(arch_ids()))
def test_plans_and_batch_divisible_match_the_reference(arch, mesh_name):
    jmesh, mesh, by_shape = _plans(arch, mesh_name)
    for name, (jplan, plan) in by_shape.items():
        sh = INPUT_SHAPES[name]
        for field in ("n_clients", "client_axes", "batch_axes",
                      "model_axes", "fsdp_axes", "seq_axes"):
            assert getattr(plan, field) == getattr(jplan, field), \
                (arch, name, field)
        assert plans.batch_divisible(get_arch(arch), sh, plan, mesh) == \
            jplans.batch_divisible(jget_arch(arch), sh, jplan, jmesh), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(arch_ids()))
def test_param_pspecs_match_the_reference(arch, mesh_name):
    jmesh, mesh, by_shape = _plans(arch, mesh_name)
    seen = set()
    for name, (jplan, plan) in by_shape.items():
        key = (plan.n_clients, plan.fsdp_axes, plan.client_axes)
        if key in seen:
            continue
        seen.add(key)
        cfg = steps.resolve_cfg(get_arch(arch), INPUT_SHAPES[name])
        jcfg = jsteps.resolve_cfg(jget_arch(arch), INPUT_SHAPES[name])
        want = _ref_specs(jspecs.param_pspecs(
            jcfg, jmesh, jplan, _ref_params(arch, jplan.n_clients)))
        got = tree.flatten(specs.param_pspecs(
            cfg, mesh, plan, _params(arch, plan.n_clients)), tuples=False)
        assert got == want, (arch, name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(arch_ids()))
def test_batch_and_decode_state_pspecs_match_the_reference(arch,
                                                           mesh_name):
    jmesh, mesh, by_shape = _plans(arch, mesh_name)
    for name, (jplan, plan) in by_shape.items():
        sh = INPUT_SHAPES[name]
        cfg = steps.resolve_cfg(get_arch(arch), sh)
        jcfg = jsteps.resolve_cfg(jget_arch(arch), sh)
        if sh.kind == "train":
            jbatch = jregistry.train_batch_specs(jcfg, sh, jnp.bfloat16,
                                                 n_clients=jplan.n_clients)
            batch = registry.train_batch_specs(cfg, sh, torch.bfloat16,
                                               n_clients=plan.n_clients)
            want = _ref_specs(jspecs.train_batch_pspecs(jcfg, jplan, jbatch))
            got = specs.train_batch_pspecs(cfg, plan, batch)
        elif sh.kind == "prefill":
            jbatch = jregistry.prefill_batch_specs(jcfg, sh, jnp.bfloat16)
            batch = registry.prefill_batch_specs(cfg, sh, torch.bfloat16)
            want = _ref_specs(jspecs.serve_batch_pspecs(jplan, jbatch))
            got = specs.serve_batch_pspecs(plan, batch)
        else:
            jstate = jregistry.decode_input_specs(jcfg, sh,
                                                  jnp.bfloat16)["state"]
            state = registry.decode_input_specs(cfg, sh,
                                                torch.bfloat16)["state"]
            want = _ref_specs(jspecs.decode_state_pspecs(jcfg, jmesh, jplan,
                                                         jstate))
            got = specs.decode_state_pspecs(cfg, mesh, plan, state)
        assert tree.flatten(got, tuples=False) == want, (arch, name)


@pytest.mark.parametrize("arch", list(arch_ids()))
def test_abstract_shapes_match_the_reference(arch):
    """The five helpers' shapes and dtypes, on the meta device (nothing
    allocated), at the full config of every arch."""
    for n_clients in (1, plans._TRAIN_TABLE[arch][1]):
        got = _params(arch, n_clients)
        assert {x.device.type for x in tree.leaves(got)} == {"meta"}
        assert _shapes(got) == _ref_shapes(_ref_params(arch, n_clients))
    for name, sh in INPUT_SHAPES.items():
        cfg = steps.resolve_cfg(get_arch(arch), sh)
        jcfg = jsteps.resolve_cfg(jget_arch(arch), sh)
        if sh.kind == "train":
            c = plans._TRAIN_TABLE[arch][1]
            got = registry.train_batch_specs(cfg, sh, n_clients=c)
            want = jregistry.train_batch_specs(jcfg, sh, n_clients=c)
        elif sh.kind == "prefill":
            got = registry.prefill_batch_specs(cfg, sh)
            want = jregistry.prefill_batch_specs(jcfg, sh)
        else:
            dec = registry.decode_input_specs(cfg, sh)
            jdec = jregistry.decode_input_specs(jcfg, sh)
            assert dec["pos"] is int and jdec["pos"].shape == ()
            got = {"token": dec["token"], "state": dec["state"]}
            want = {"token": jdec["token"], "state": jdec["state"]}
        assert _shapes(got) == _ref_shapes(want), (arch, name)


def test_train_batch_specs_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="divide evenly"):
        registry.train_batch_specs(get_arch("phi4-mini-3.8b"),
                                   INPUT_SHAPES["train_4k"], n_clients=3)


# ---------------------------------------------------------------------------
# shard_tree / gather_tree
# ---------------------------------------------------------------------------

ROUND_TRIP = [
    # (mesh shape, axes, leaf shape, spec)
    ((2, 3), ("data", "model"), (12, 5), (("data", "model"), None)),
    ((2, 3), ("data", "model"), (12, 5), (("model", "data"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6),
     (("pod", "data"), None, ("model",))),
    ((2, 2, 2), ("pod", "data", "model"), (3, 8),
     (None, ("pod", "data", "model"))),
    ((2, 1), ("data", "model"), (4, 6), (("data",), ("model",))),
    ((2, 3), ("data", "model"), (6, 4), (None, None)),
]


@pytest.mark.parametrize("case", range(len(ROUND_TRIP)))
def test_shard_and_gather_round_trip(case):
    """Each rank's block is the reference's block of a ``NamedSharding``
    (row-major over the entry's coordinates, in the order named; an axis
    of extent 1 splits nothing), and the blocks of every rank gather back
    to the leaf."""
    shape, axes, leaf_shape, spec = ROUND_TRIP[case]
    x = torch.arange(int(np.prod(leaf_shape)),
                     dtype=torch.float32).reshape(leaf_shape)
    n = int(np.prod(shape))
    blocks = [specs.shard_tree({"x": x}, {"x": spec},
                               specs.MeshShape(axes, shape, r))
              for r in range(n)]
    for r, b in enumerate(blocks):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        want = x
        for d, entry in enumerate(spec):
            if not entry:
                continue
            sizes = [shape[axes.index(a)] for a in entry]
            k = int(np.ravel_multi_index([coords[a] for a in entry], sizes))
            m = leaf_shape[d] // int(np.prod(sizes))
            want = want.narrow(d, k * m, m)
        assert torch.equal(b["x"], want), (r, spec)
    back = specs.gather_tree(blocks, {"x": spec}, specs.MeshShape(axes, shape))
    assert torch.equal(back["x"], x)


def test_shard_refuses_an_uneven_split_and_gather_differing_replicas():
    mesh = specs.MeshShape(("data", "model"), (2, 3))
    with pytest.raises(ValueError, match="does not split"):
        specs.shard_tree({"x": torch.zeros(4, 5)},
                         {"x": (None, ("model",))}, mesh)
    blocks = [{"x": torch.full((2,), float(r))} for r in range(6)]
    with pytest.raises(ValueError, match="replicas"):
        specs.gather_tree(blocks, {"x": (("data",),)}, mesh)
