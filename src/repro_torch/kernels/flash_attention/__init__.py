"""Blocked (flash) attention forward: CUDA kernel
(``csrc/flash_attention.cu``), its wrappers (``ops.py``) and its plain
PyTorch version (``ref.py``)."""
