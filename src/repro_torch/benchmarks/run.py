"""The one-command benchmark harness (the JAX package's ``benchmarks/run.py``):
every paper table and figure and every bench of the port in one run.

Prints ``name,us_per_call,derived`` CSV lines and writes the structured
results, under the reference's keys, to ``--out`` (default
``build/bench_results.json``; the reference's record,
``experiments/bench_results.json``, is refused). Beside them the JSON
holds ``device`` (the card's ``nvidia-smi`` name and power limit and
torch's version; ``"cpu"`` on the CPU) and ``section_s`` (each section's
wall seconds on the host clock).

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # everything
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig3,table6
  PYTHONPATH=src python -m repro_torch.benchmarks.run --fast     # mnist only

A section that raises is recorded as ``{"error": ...}`` and the others
still run, as in the reference; unlike the reference the harness then
exits 1. On ``--device cpu`` the ``kernels`` section is recorded as
``{"skipped": ...}`` (``bench_kernels`` times the CUDA kernels on the card
alone). A run with ``--only`` merges its sections over an existing
``--out``. The ``roofline`` sections read the dry-run's records
(``--dryrun-dir``, default ``build/dryrun/``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.benchmarks import (bench_cohort, bench_hierarchy,
                                    bench_kernels, bench_multidevice,
                                    bench_robust, bench_rounds,
                                    bench_schedules, bench_topology,
                                    paper_tables, roofline)
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.dryrun import ROOT

OUT = os.path.join(ROOT, "build", "bench_results.json")
REFERENCE_OUT = os.path.join(ROOT, "experiments", "bench_results.json")

PAPER = {"fig3": paper_tables.fig3_bound_gap,
         "table2": paper_tables.table2_alpha,
         "table3": paper_tables.table3_beta,
         "table4": paper_tables.table4_clients,
         "table5": paper_tables.table5_eta,
         "table6": paper_tables.table6_lazy,
         "table7": paper_tables.table7_sigma,
         "fig10": paper_tables.fig10_dp}
BENCHES = ("kernels", "rounds", "topology", "schedules", "cohort",
           "multidevice", "hierarchy", "robust", "roofline")


def device_entry(dev) -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, and
    torch's version; ``"cpu"`` in place of the card on the CPU."""
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return {"card": card, "torch": torch.__version__}


def sections(only, datasets, seed, device, dryrun_dir
             ) -> List[Tuple[str, str, Callable[[], Dict]]]:
    """(``--only`` name, result key, thunk) of each section to run, in the
    reference's order."""
    out = []
    for name, fn in PAPER.items():
        if only is None or name in only:
            out += [(name, f"{name}_{ds}",
                     lambda fn=fn, ds=ds: fn(ds, seed, device=device))
                    for ds in datasets]
    benches = {
        "kernels": [("kernels", lambda: bench_kernels.bench(device))],
        "rounds": [("rounds_scan_vs_loop",
                    lambda: bench_rounds.bench("bench", device=device)),
                   ("rounds_kernel_path",
                    lambda: bench_rounds.bench_kernel_path(device=device))],
        "topology": [("topology_loss_vs_k",
                      lambda: bench_topology.bench(device=device))],
        "schedules": [("schedules_loss_vs_k",
                       lambda: bench_schedules.bench(device=device))],
        "cohort": [("cohort_population_scaling",
                    lambda: bench_cohort.bench(device=device))],
        "multidevice": [("multidevice_rounds_per_s",
                         lambda: bench_multidevice.bench(device=device))],
        "hierarchy": [("hierarchy_flat_vs_cluster",
                       lambda: bench_hierarchy.bench(device=device))],
        "robust": [("robust_attack_defense",
                    lambda: bench_robust.bench(device=device))],
        "roofline": [(f"roofline_{mesh}",
                      lambda mesh=mesh: roofline.run(mesh, dryrun_dir))
                     for mesh in ("pod16x16", "pod2x16x16")],
    }
    for name in BENCHES:
        if only is None or name in only:
            out += [(name, key, fn) for key, fn in benches[name]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join([*PAPER, *BENCHES]))
    ap.add_argument("--fast", action="store_true",
                    help="mnist proxy only (skip fashion)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--dryrun-dir", default=None,
                    help="the dry-run's records (default build/dryrun/)")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only is not None and not only <= {*PAPER, *BENCHES}:
        ap.error(f"unknown --only names {sorted(only - {*PAPER, *BENCHES})}")
    out = os.path.abspath(args.out)
    if os.path.realpath(out) == os.path.realpath(REFERENCE_OUT):
        ap.error(f"--out {args.out} is the JAX package's record; write "
                 "the port's elsewhere")
    dev = resolve_device(args.device)
    device = str(dev)
    datasets = ["mnist"] if args.fast else ["mnist", "fashion"]

    results = {"device": device_entry(dev), "section_s": {}}
    failed = []
    t0 = time.time()
    if dev.type == "cuda":   # one nvcc a source at once, before any section
        _build.build_all()
        print(f"# kernels built in {time.time() - t0:.1f}s")
    print("name,us_per_call,derived")
    for name, key, fn in sections(only, datasets, args.seed, device,
                                  args.dryrun_dir):
        t_section = time.perf_counter()
        if name == "kernels" and dev.type != "cuda":
            results[key] = {"skipped": "bench_kernels times the CUDA "
                                       "kernels on the card; the CPU runs "
                                       "their plain versions"}
        else:
            try:
                results[key] = fn()
            except Exception as e:   # keep the harness running
                traceback.print_exc()
                print(f"{key},0,ERROR:{type(e).__name__}:{e}", flush=True)
                results[key] = {"error": f"{type(e).__name__}: {e}"}
                failed.append(key)
        results["section_s"][key] = time.perf_counter() - t_section

    os.makedirs(os.path.dirname(out), exist_ok=True)
    if only is not None and os.path.exists(out):
        # partial runs merge over the previous results instead of dropping
        # every section they didn't re-run
        with open(out) as f:
            merged = json.load(f)
        section_s = {**merged.get("section_s", {}), **results["section_s"]}
        merged.update(results)
        merged["section_s"] = section_s
        results = merged
    with open(out, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(f"# total {time.time() - t0:.1f}s -> {out}")
    if failed:
        print(f"# failed sections: {','.join(failed)}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
