"""The dry-run's roofline table (the JAX package's ``benchmarks/roofline.py``):
read the port's dry-run records into the per-(arch x shape x mesh)
three-term table, name each pair's dominant term and what would move it;
and the analytic bytes of one integrated round's hot block.

The records are ``launch/dryrun.py``'s (``build/dryrun/*.json`` by
default, its ``OUT_DIR``); every reader takes ``dryrun_dir=`` where the
reference reads a module constant. Nothing here touches a device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only roofline \\
      --device cpu
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.benchmarks import common
from repro_torch.launch.dryrun import OUT_DIR

_SUGGESTIONS = {
    "compute_s": "raise arithmetic intensity: larger microbatch per device "
                 "or fewer local iterations per aggregate",
    "memory_s": "cut HBM round-trips: chunkwise-parallel recurrence, fused "
                "kernels, larger fusion blocks, bf16 states",
    "collective_s": "overlap or shrink collectives: hierarchical aggregate, "
                    "quantized all-reduce, fewer aggregation boundaries",
}


def round_hot_block_bytes(model_bytes: float, n_clients: int,
                          mine_attempts: int, *, n_devices: int = 1,
                          fused_mix: bool = False,
                          fast_allreduce: bool = False) -> Dict[str, float]:
    """Analytic per-device bytes moved by ONE integrated round's hot block
    (the reference's function, term for term).

    Counts the model-sized traffic of each stage (the PoW race is
    compute-bound — it contributes hashes, not bytes):

      * ``train_bytes`` — each local client reads + writes its own model
        during the tau-step local update;
      * ``collective_bytes`` — the communicate stage's receive volume
        (all-gather of the C − C/D remote client blocks, or a ring
        all-reduce of ONE model when ``fast_allreduce``);
      * ``mix_bytes`` — the [C,C] x [C,P] mix reads the C broadcast models
        once and writes C rows — or only the C/D LOCAL rows when the fused
        kernel's row-select does the slicing inside the contraction;
      * ``diag_bytes`` — digest + divergence sweep the broadcast set twice
        on the reference's plain path, ONCE with the fused single-sweep
        kernel. The port always makes the one sweep (``digest_div_flat``),
        so with ``fused_mix=False`` this term counts a sweep it does not
        make; it is kept so the figures compare with the reference's.
    """
    if n_devices < 1 or n_clients % n_devices:
        raise ValueError(f"need n_devices >= 1 dividing C={n_clients}, "
                         f"got {n_devices}")
    local = n_clients // n_devices
    train = 2.0 * local * model_bytes
    if n_devices == 1:
        coll = 0.0
    elif fast_allreduce:
        coll = 2.0 * (n_devices - 1) / n_devices * model_bytes
    else:
        coll = float(n_clients - local) * model_bytes
    rows_written = local if fused_mix else n_clients
    mix = float(n_clients + rows_written) * model_bytes
    sweeps = 1.0 if fused_mix else 2.0
    diag = sweeps * n_clients * model_bytes
    return {"train_bytes": train, "collective_bytes": coll,
            "mix_bytes": mix, "diag_bytes": diag,
            "total_bytes": train + coll + mix + diag,
            "pow_hashes": float(mine_attempts) * local}


def load_records(pattern: str = "*.json",
                 dryrun_dir: Optional[str] = None) -> List[Dict]:
    """Every record under ``dryrun_dir`` (default ``build/dryrun/``)
    matching ``pattern``, in file-name order."""
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir or OUT_DIR,
                                              pattern))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table(mesh: str = "pod16x16",
          dryrun_dir: Optional[str] = None) -> List[Dict]:
    """One row a record of ``mesh``: its terms, the dominant one and what
    would move it; ``reason`` for a pair that is not ok."""
    rows = []
    for r in load_records(dryrun_dir=dryrun_dir):
        if r.get("mesh") != mesh:
            continue
        row = {"arch": r["arch"], "shape": r["shape"], "status": r["status"]}
        if r["status"] == "ok":
            rl = r["roofline"]
            row.update({
                "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
                "collective_s": rl["collective_s"],
                "dominant": rl["dominant"], "bound_s": rl["bound_s"],
                "useful_flops_ratio": r.get("useful_flops_ratio"),
                "model_flops": r.get("model_flops"),
                "fix": _SUGGESTIONS[rl["dominant"]],
            })
        else:
            row["reason"] = r.get("reason", r.get("error"))
        rows.append(row)
    return rows


def run(mesh: str = "pod16x16", dryrun_dir: Optional[str] = None
        ) -> List[Dict]:
    """:func:`table`, with the reference's CSV line and one line a pair."""
    rows = table(mesh, dryrun_dir)
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        common.csv_line("roofline", 0.0, "no dry-run records; run "
                        "python -m repro_torch.launch.dryrun --all "
                        "--both-meshes first")
        return rows
    n_comp = sum(r["dominant"] == "compute_s" for r in ok)
    n_mem = sum(r["dominant"] == "memory_s" for r in ok)
    n_coll = sum(r["dominant"] == "collective_s" for r in ok)
    worst = max(ok, key=lambda r: r["bound_s"])
    common.csv_line(
        f"roofline_{mesh}", 0.0,
        f"pairs={len(ok)};compute_bound={n_comp};memory_bound={n_mem};"
        f"collective_bound={n_coll};worst={worst['arch']}x{worst['shape']}")
    for r in ok:
        print(f"  {r['arch']:24s} {r['shape']:12s} "
              f"C={r['compute_s']:9.3g}s M={r['memory_s']:9.3g}s "
              f"X={r['collective_s']:9.3g}s -> {r['dominant']}")
    return rows
