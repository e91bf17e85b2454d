"""Carry the JAX package's arrays across as numpy, so that both packages
compute on the same numbers.

``params_from_jax`` takes the reference's MLP params (``init_mlp``), or its
client-stacked ``[C, ...]`` params, as a dict of numpy arrays.
"""
from __future__ import annotations

from typing import Dict

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

