"""Device resolution with no silent CPU path.

Every entry point of the port takes ``device`` and defaults to ``"cuda"``.
Asking for the GPU on a machine without one raises: a run that was meant
for the card never quietly falls back to the CPU. Pass ``device="cpu"`` to
run on the CPU on purpose (the tests do).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names a GPU that is not
    there. Only ``cpu`` and ``cuda[:i]`` are accepted."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device={device!r}: only {torch.cuda.device_count()} CUDA "
            "device(s) present")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
