"""Hand-written CUDA kernels for sm_90a and their wrappers.

Each kernel's wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); :data:`WRAPPERS` lists them so that a run can reset
the counts and read them back to show which kernels it went through.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.pow_hash import ops as pow_ops

# kernel name -> wrapper that launches it
WRAPPERS = {
    "pow_race": pow_ops.pow_race_flat,
    "fedavg_flat": fedavg_ops.fedavg_flat,
    "digest_div_flat": fedavg_ops.digest_div_flat,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
