"""carried_mb_per_job (MB): device memory a job leaves allocated for the
jobs after it, the mean over the window's jobs (the growth of what each
job finds allocated at its start, from the first job's start to the
last's). ``peak_mem_gb`` leaves it out, so this shows it. Layer: the round
driver (``core/rounds.py``: ``CapturedRounds``, ``release_graphs``, whose
side stream and its cuBLAS workspace each job's graphs make anew)."""


def read(r):
    starts = [s for s in r.start_bytes if s]
    if r.device is None or len(starts) < 2:
        return None
    return (starts[-1] - starts[0]) / (len(starts) - 1) / 1e6
