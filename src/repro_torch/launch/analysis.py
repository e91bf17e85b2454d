"""Roofline terms of a step from its per-rank costs (the JAX package's
``launch/analysis.py``), with the NVIDIA H100's constants in place of the
TPU v5e's.

Three terms a rank, for a step whose per-rank flops, HBM bytes and
received collective bytes the dry-run counted (``launch/dryrun.py``,
``launch/cost_analysis.py``):

  compute    = flops / peak_flops    (bf16 by default, fp32 on request)
  memory     = hbm_bytes / HBM_BW
  collective = collective_bytes / NVLINK_BW

The constants are the H100 SXM5 80 GB data sheet's, at 700 W, dense (no
sparsity): 989.4 Tflop/s in bf16 on the tensor cores (the default: the
dry-run's steps are bf16, as the reference's ``build_step`` default is),
66.9 Tflop/s in fp32 outside them (no TF32: how the port's fp32 GEMMs run
on the card; ``roofline(..., peak_flops=PEAK_FLOPS_FP32)``), HBM3 at
3.35 TB/s, and NVLink at 450 GB/s received a GPU (900 GB/s both ways).
The collective term assumes every axis stays inside one NVLink domain of
8 GPUs; an axis that leaves the node would run at its NIC's rate instead,
which no term here models.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989.4e12     # a GPU, dense, tensor cores
PEAK_FLOPS_FP32 = 66.9e12      # a GPU, outside the tensor cores (no TF32)
HBM_BW = 3.35e12               # bytes/s a GPU
NVLINK_BW = 450e9              # bytes/s received a GPU


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float, chips: int, *,
             peak_flops: float = PEAK_FLOPS_BF16) -> Dict[str, float]:
    """The reference's terms and keys (``compute_s``, ``memory_s``,
    ``collective_s``, ``dominant``, ``bound_s``, ``chips``, ``total_flops``,
    ``total_bytes``) from per-rank costs over ``chips`` ranks."""
    compute_s = flops_per_dev / peak_flops
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dom,
        "bound_s": terms[dom],
        "chips": chips,
        "total_flops": flops_per_dev * chips,
        "total_bytes": bytes_per_dev * chips,
    }


def model_flops(n_active_params: int, tokens: float, backward: bool,
                local_iters: int = 1) -> float:
    """6·N·D for training (forward and backward), 2·N·D for inference."""
    per_tok = 6.0 if backward else 2.0
    return per_tok * n_active_params * tokens * local_iters
