"""flash_bwd_roofline (%): the least time of the window's attention
backwards over the device time of the flash backward's kernels
(``kernels/flash_attention``: the rows' D, dK/dV, dQ and, under GQA, the
group sum). A round runs each client's tau backwards, each attention
layer once; the least time of a call is ``counts.flash_call`` at the
chip's peaks."""
from fl_bench import counts, families, peaks

KERNELS = r"\b(delta_kernel|dkdv_kernel|dq_kernel|group_sum_kernel)\b"


def read(r):
    if r.device is None:
        return None
    seconds = r.device.seconds(KERNELS)
    if not seconds:
        return None
    t, spec = r.traffic, r.traffic["spec"]
    least = peaks.least_seconds(*counts.flash_call(r.widths, t, True))
    calls = r.rounds * spec["n_clients"] * spec["tau"] \
        * families.load(r.widths["family"]).attention_layers(r.widths)
    return 100.0 * calls * least / seconds
