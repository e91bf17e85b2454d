"""Nested params as the JAX package lays them out (dicts and lists of
tensors), flattened to path strings and back.

A leaf's path is its dict keys and list indices joined by ``/``, in the
order ``jax.tree_util`` walks the same tree (dict keys sorted, list items
in order): ``"period/j0/mixer/w_q"``, ``"prefix/0/norm1"``. These are the
reference checkpoint's keys (``training/checkpoint.py``), and the round
engine (``core/rounds.py``), whose params are one flat dict, runs an LM
on its flattened params (``models/registry.py::client_losses``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten(tree: Any, prefix: str = "", tuples: bool = True
            ) -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts and lists, in the reference's
    leaf order; a leaf at the root has the path ``""``. With ``tuples``
    off a tuple is a leaf (a spec tree's, ``sharding/specs.py``)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, list) or (tuples and isinstance(tree, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}/{key}" if prefix else key,
                           tuples))
    return out


def unflatten(flat: Dict[str, Any]) -> Any:
    """The tree of :func:`flatten`'s output: a level whose keys are all
    the indices 0 .. n-1 becomes a list, every other level a dict."""
    if set(flat) == {""}:
        return flat[""]
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _lists(root)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` applied leaf by leaf, the tree's structure kept
    (paths as :func:`flatten` names them)."""
    def path(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def leaves(tree: Any) -> list:
    """The leaves in :func:`flatten`'s order."""
    return list(flatten(tree).values())
