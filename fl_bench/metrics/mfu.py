"""mfu (%): the window's model flops over the window's host seconds at the
chip's peak (``peaks.FLOPS``): every round's tau forward and backward passes
of each client and its global-loss forward (``counts.round_flops``). Layer:
the whole round (``core/rounds.py::make_integrated_round``)."""
from fl_bench import counts, peaks


def read(r):
    if r.device is None:
        return None
    flops = counts.round_flops(r.widths, r.traffic) * r.rounds
    return 100.0 * flops / (r.window_s * peaks.FLOPS)
