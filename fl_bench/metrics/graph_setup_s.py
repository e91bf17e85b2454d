"""graph_setup_s (s): a job's warm round and CUDA-graph captures on the
host clock, as the graph driver records them (``rounds.LAST_GRAPH``'s
``warm_s + capture_s``), the mean over the window's jobs. Layer: the round
driver (``core/rounds.py``: ``run_blade_fl`` -> ``RoundRunner``,
``CapturedRounds``); every job pays it once before its replays."""


def read(r):
    seconds = [j.graph["warm_s"] + j.graph["capture_s"] for j in r.jobs
               if j.graph]
    return sum(seconds) / len(seconds) if seconds else None
