"""The PoW nonce race: CUDA kernel (``csrc/pow_race.cu``), its wrappers
(``ops.py``) and its plain PyTorch version (``ref.py``)."""
