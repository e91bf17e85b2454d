"""Carry the JAX package's arrays across as numpy, so that both packages
compute on the same numbers.

``params_from_jax`` takes the reference's MLP params (``init_mlp``), or its
client-stacked ``[C, ...]`` params, as a dict of numpy arrays;
``lm_params_from_jax`` takes an LM's nested params (``init_lm``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_jax(np_params: Dict[str, np.ndarray],
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """numpy params (float leaves) -> contiguous float32 tensors on
    ``device``, same keys and shapes."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_params.items():
        v = np.asarray(v)
        if not np.issubdtype(v.dtype, np.floating):
            raise TypeError(f"param {k!r} has dtype {v.dtype}, not float")
        out[k] = torch.from_numpy(np.array(v, np.float32)).to(dev)
    return out


def batch_from_numpy(np_batch: Dict[str, np.ndarray],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: floats as float32, integer
    labels as int64."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_batch.items():
        v = np.asarray(v)
        dtype = np.float32 if np.issubdtype(v.dtype, np.floating) else np.int64
        out[k] = torch.from_numpy(np.array(v, dtype)).to(dev)
    return out



def lm_params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """An LM's params as the reference's tree of numpy arrays (nested dicts
    and lists, e.g. ``jax.tree.map(np.asarray, params)``) -> the same tree
    of contiguous float32 tensors on ``device``."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v) for v in x]
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            raise TypeError(f"LM param of dtype {x.dtype}, not float")
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return convert(tree)
