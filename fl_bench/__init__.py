"""The benchmark of the PyTorch and CUDA port (``repro_torch``): BLADE-FL
training jobs of published-width language models on one NVIDIA H100.

``python3 fl_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell that ``BENCHMARK.json`` names. A cell is a
configuration (``configs/<name>.json``, which names its model family,
``families/<family>.py``) under a traffic mix (``traffic/<name>.json``,
which names its kind of job, ``jobs/<job>.py``, and the ``RoundSpec`` it
runs), judged by the limits of ``limits/<cell>.json``; each per-layer
metric is a reader of its own (``metrics/<name>.py``). The harness finds
every piece by its name, so a later cell, configuration, family, kind of
job or metric is a file and an entry, with no edit of what is here.
"""
