"""The Mamba (S6) selective scan: CUDA kernel (``csrc/ssm_scan.cu``), its
wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""
