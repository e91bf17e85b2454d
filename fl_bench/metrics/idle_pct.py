"""idle_pct (%): the share of the traced window in which no kernel, copy
or fill runs on the device (the complement of the union of their
intervals). Layer: the device (one H100)."""


def read(r):
    if r.device is None or not r.device.window_s:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)
