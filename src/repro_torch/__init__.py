"""BLADE-FL in PyTorch for one NVIDIA H100.

The package mirrors the JAX package's layout (``core/``, ``models/``,
``data/``, ``kernels/``, ``launch/``, ``configs/``) so that each module has
an obvious counterpart. It imports torch, numpy and the standard library
only. Its hot spots are CUDA kernels written by hand for ``sm_90a``
(``kernels/*/csrc``); each kernel keeps a plain PyTorch version beside it
that serves CPU tensors and tests.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when no GPU is present (``device.py``).
"""
from repro_torch.device import resolve_device  # noqa: F401
