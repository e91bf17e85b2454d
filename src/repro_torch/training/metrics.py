"""Lightweight metric logging: in-memory history + CSV/JSONL writers."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricLogger:
    def __init__(self, out_dir: Optional[str] = None, name: str = "train"):
        self.history: List[Dict] = []
        self.out_dir = out_dir
        self.name = name
        self._t0 = time.time()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def log(self, step: int, **metrics) -> Dict:
        rec = {"step": step, "wall": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.history.append(rec)
        if self.out_dir:
            with open(os.path.join(self.out_dir, f"{self.name}.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.history if key in r]

    def best(self, key: str, mode: str = "min") -> Dict:
        sel = min if mode == "min" else max
        return sel((r for r in self.history if key in r), key=lambda r: r[key])
