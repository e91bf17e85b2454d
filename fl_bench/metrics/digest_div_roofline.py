"""digest_div_roofline (%): the least time of the window's digest and
divergence sweeps over the device time of their kernels
(``kernels/fedavg``, ``digest_div_flat``: ``digest_div_reg`` and
``digest_div_slab``): each round reads every leaf's C rows once and writes
its sum and C residuals (``counts.digest_bytes``), at the chip's
bandwidth. Layer: the FL aggregation kernels."""
from fl_bench import counts, peaks

KERNELS = r"\bdigest_div_(reg|slab)\b"


def read(r):
    if r.device is None:
        return None
    seconds = r.device.seconds(KERNELS)
    if not seconds:
        return None
    least = counts.digest_bytes(r.widths, r.traffic["spec"]["n_clients"]) \
        / peaks.HBM_BYTES
    return 100.0 * r.rounds * least / seconds
