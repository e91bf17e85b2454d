"""Checkpoints without external dependencies, in the JAX package's format
(``training/checkpoint.py``): ``ckpt_<step:08d>.npz`` holds the leaves
under their path strings (dict keys and list indices joined by ``/``,
``tree.flatten``) and ``ckpt_<step:08d>.json`` the step, the keys and the
BLADE-FL ledger, so that a restart resumes the hash chain.

A checkpoint written by either package restores in the other: both name
the leaves alike, and the reference's ``restore`` never reads the
structure note (``treedef``: its own JAX repr there, the port's nested
key outline here).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import chain as chain_lib


def _outline(tree: Any) -> Any:
    """The tree's structure with each leaf replaced by its shape."""
    if isinstance(tree, dict):
        return {str(k): _outline(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_outline(v) for v in tree]
    return list(np.shape(tree))


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, tree: Any, step: int = 0,
         ledger: Optional[chain_lib.Ledger] = None) -> str:
    """Write ``tree`` (dicts and lists of tensors or arrays) and
    ``ledger`` as checkpoint ``step`` in ``directory``; returns the
    ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _numpy(v) for k, v in tree_lib.flatten(tree).items()}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **arrays)
    meta = {"step": step, "treedef": json.dumps(_outline(tree)),
            "keys": list(arrays)}
    if ledger is not None:
        meta["ledger"] = [vars(b) for b in ledger.blocks]
        meta["difficulty_bits"] = ledger.difficulty_bits
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def restore(directory: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Optional[chain_lib.Ledger]]:
    """Restore into the structure of ``template`` (shapes must match; each
    leaf takes the template leaf's dtype and device): ``(tree, step,
    ledger or None)``. Without ``step``, the last checkpoint."""
    ckpts = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    name = f"ckpt_{step:08d}.npz" if step is not None else ckpts[-1]
    data = np.load(os.path.join(directory, name))

    def leaf(path, tmpl):
        arr = data[path]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {path}: stored shape {arr.shape} does not "
                f"match template shape {tuple(tmpl.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=tmpl.dtype,
                                                  device=tmpl.device)

    tree = tree_lib.map_with_path(leaf, template)
    meta_path = os.path.join(directory, name.replace(".npz", ".json"))
    got_step, ledger = 0, None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        got_step = meta.get("step", 0)
        if "ledger" in meta:
            ledger = chain_lib.Ledger(meta.get("difficulty_bits", 0))
            for b in meta["ledger"]:
                ledger.append(chain_lib.Block(**b))
    return tree, got_step, ledger
