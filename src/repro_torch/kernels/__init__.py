"""Hand-written CUDA kernels for sm_90a and their wrappers.

Each kernel's wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); :data:`WRAPPERS` lists them so that a run can reset
the counts and read them back to show which kernels it went through. A
CUDA graph's replay launches what it captured without calling a wrapper:
the graph driver (``core/rounds.py``) takes back the counts its captures
made and adds them again at each replay (:func:`add_launch_counts`). The
two backward kernels (``flash_attention_bwd``, ``ssm_scan_bwd``) count one
a backward call, however many CUDA launches the call makes.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.pow_hash import ops as pow_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops

# kernel name -> wrapper that launches it
WRAPPERS = {
    "pow_race": pow_ops.pow_race_flat,
    "fedavg_flat": fedavg_ops.fedavg_flat,
    "mix_rows_flat": fedavg_ops.mix_rows_flat,
    "digest_div_flat": fedavg_ops.digest_div_flat,
    "flash_attention": flash_ops.flash_attention,
    "flash_attention_bwd": flash_ops.flash_attention_bwd,
    "ssm_scan": ssm_ops.ssm_scan,
    "ssm_scan_bwd": ssm_ops.ssm_scan_bwd,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, negative to take back) to
    the wrappers' counts."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n
