"""The dry-run's markdown tables (the JAX package's
``benchmarks/gen_experiments.py``): §Dry-run, each pair's status, trace
seconds and per-rank costs, and §Roofline, each ok pair's three terms at
the H100's constants (``launch/analysis.py``), from the port's dry-run
records (``build/dryrun/*.json``, or ``--in DIR``). Prints to stdout and
writes no file.

  PYTHONPATH=src python -m repro_torch.benchmarks.gen_experiments [--in DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.launch import analysis
from repro_torch.launch.dryrun import OUT_DIR


def fmt(x, unit=""):
    if x is None:
        return "-"
    if isinstance(x, str):
        return x
    a = abs(x)
    if a >= 1e4 or (a < 1e-2 and a > 0):
        return f"{x:.3g}{unit}"
    return f"{x:.3f}{unit}"


def load(mesh, dryrun_dir: Optional[str] = None):
    """{(arch, shape): record} of ``mesh`` under ``dryrun_dir`` (default
    ``build/dryrun/``)."""
    recs = {}
    for p in sorted(glob.glob(os.path.join(dryrun_dir or OUT_DIR,
                                           "*.json"))):
        if p.endswith(".baseline.json"):
            continue
        with open(p) as f:
            r = json.load(f)
        if r.get("mesh") == mesh:
            recs[(r["arch"], r["shape"])] = r
    return recs


SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCHS = ["xlstm-125m", "qwen3-32b", "nemotron-4-15b", "jamba-1.5-large-398b",
         "paligemma-3b", "hubert-xlarge", "phi4-mini-3.8b",
         "kimi-k2-1t-a32b", "minicpm-2b", "deepseek-v2-236b"]


def dryrun_section(dryrun_dir: Optional[str] = None):
    """Each pair's status, trace seconds, and rank 0's counted flops, HBM
    bytes, received collective bytes and peak live bytes (the record's
    ``trace_s``, ``cost`` and ``memory``)."""
    print("## §Dry-run\n")
    for mesh, label in [("pod16x16", "single-pod (16x16 = 256 GPUs)"),
                        ("pod2x16x16", "multi-pod (2x16x16 = 512 GPUs)")]:
        recs = load(mesh, dryrun_dir)
        n_ok = sum(r["status"] == "ok" for r in recs.values())
        n_skip = sum(r["status"] == "skipped" for r in recs.values())
        n_fail = len(recs) - n_ok - n_skip
        print(f"### {label}: {n_ok} ok / {n_skip} skipped / {n_fail} failed\n")
        print("| arch | shape | status | trace s | flops/dev "
              "| HBM bytes/dev | coll bytes/dev | peak live bytes/dev |")
        print("|---|---|---|---|---|---|---|---|")
        for a in ARCHS:
            for s in SHAPES:
                r = recs.get((a, s))
                if r is None:
                    continue
                if r["status"] != "ok":
                    why = r.get("reason", r.get("error", ""))[:60]
                    print(f"| {a} | {s} | {r['status']}: {why} | | | | | |")
                    continue
                c = r["cost"]
                mem = r.get("memory", {}).get("peak_live_bytes", 0)
                print(f"| {a} | {s} | ok | {r['trace_s']} "
                      f"| {fmt(c['flops'])} | {fmt(c['hbm_bytes'])} "
                      f"| {fmt(c['collective_bytes'])} | {fmt(float(mem))} |")
        print()


def roofline_section(dryrun_dir: Optional[str] = None):
    """The reference's rows: each ok pair of ``pod16x16``'s three terms,
    the dominant one, model flops and the useful ratio."""
    print(f"## §Roofline (single-pod, 256 GPUs; H100 SXM: "
          f"{analysis.PEAK_FLOPS_BF16 / 1e12:g} TF/s bf16 dense, "
          f"{analysis.PEAK_FLOPS_FP32 / 1e12:g} TF/s fp32, "
          f"{analysis.HBM_BW / 1e12:g} TB/s HBM, "
          f"{analysis.NVLINK_BW / 1e9:g} GB/s NVLink)\n")
    recs = load("pod16x16", dryrun_dir)
    print("| arch | shape | compute s | memory s | collective s | dominant "
          "| MODEL_FLOPS | useful ratio |")
    print("|---|---|---|---|---|---|---|---|")
    for a in ARCHS:
        for s in SHAPES:
            r = recs.get((a, s))
            if r is None or r["status"] != "ok":
                continue
            rl = r["roofline"]
            print(f"| {a} | {s} | {fmt(rl['compute_s'])} "
                  f"| {fmt(rl['memory_s'])} | {fmt(rl['collective_s'])} "
                  f"| {rl['dominant'].replace('_s','')} "
                  f"| {fmt(r['model_flops'])} "
                  f"| {fmt(r['useful_flops_ratio'])} |")
    print()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="dryrun_dir", default=None,
                    help="the records' directory (default build/dryrun/)")
    a = ap.parse_args(argv)
    dryrun_section(a.dryrun_dir)
    roofline_section(a.dryrun_dir)


if __name__ == "__main__":
    main()
