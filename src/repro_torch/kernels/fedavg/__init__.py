"""The FedAvg aggregate and the digest/divergence sweep: CUDA kernels
(``csrc/fedavg.cu``), their wrappers (``ops.py``) and their plain PyTorch
versions (``ref.py``)."""
