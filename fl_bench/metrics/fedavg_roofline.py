"""fedavg_roofline (%): the least time of the window's FedAvg over the
device time of ``fedavg_kernel`` (``kernels/fedavg``, ``fedavg_flat``):
each round reads every leaf's C rows and writes them once
(``counts.fedavg_bytes``), at the chip's bandwidth. Layer: the FL
aggregation kernels."""
from fl_bench import counts, peaks

KERNEL = r"\bfedavg_kernel\b"


def read(r):
    if r.device is None:
        return None
    seconds = r.device.seconds(KERNEL)
    if not seconds:
        return None
    least = counts.fedavg_bytes(r.widths, r.traffic["spec"]["n_clients"]) \
        / peaks.HBM_BYTES
    return 100.0 * r.rounds * least / seconds
