"""The traced run: the window under ``torch.profiler``, read back from its
chrome trace (written under ``TMPDIR`` and deleted once read).

The harness marks its own spans (``fl_bench.window`` around the window;
``fl_bench.make_batch``, ``fl_bench.job`` and ``fl_bench.release`` around
its calls into the program); the device's activity is every kernel, copy
and fill the profiler saw inside the window. A gap in that activity is
labelled by the innermost harness span around its middle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "fl_bench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Tracer:
    """Spans and the profiler when tracing; no-ops otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof: Optional[torch.profiler.profile] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def profile(self):
        if not self.enabled:
            return contextlib.nullcontext()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        return self.prof


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]    # (name, start s, seconds)
    gaps: List[Tuple[str, float]]          # (label, seconds), longest first

    def seconds(self, pattern: str) -> float:
        """Device seconds of the ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(d for name, _, d in self.ops if rx.search(name))

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, _, d in self.ops:
            by_name[name] = by_name.get(name, 0.0) + d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[label, s] for label, s in self.gaps[:TOP]]}


def _load(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="fl_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def from_events(events: list) -> DeviceTrace:
    """The window's device activity from chrome-trace events (times in
    microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    window = [e for e in spans if e["name"] == PREFIX + "window"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            ops.append((e["name"], a, b))
    ops.sort(key=lambda o: o[1])
    busy, gaps, edge = 0.0, [], w0
    inner = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(PREFIX):]) for e in spans
                    if e["name"] != PREFIX + "window"),
                   key=lambda s: s[1] - s[0])

    def label(t: float) -> str:
        return next((name for a, b, name in inner if a <= t <= b), "window")

    for _, a, b in ops + [("", w1, w1)]:
        if a > edge:
            gaps.append((label((a + edge) / 2), (a - edge) * 1e-6))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    gaps.sort(key=lambda g: -g[1])
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        ops=[(name, (a - w0) * 1e-6, (b - a) * 1e-6) for name, a, b in ops],
        gaps=gaps)


def read(tracer: Tracer) -> DeviceTrace:
    return from_events(_load(tracer.prof))


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets: the cell's widths and traffic,
    the window's jobs, rounds and host seconds, the device memory each job
    found allocated at its start (bytes; empty off the card), and the
    device trace (None in an untraced run)."""
    widths: dict
    traffic: dict
    jobs: list
    rounds: int
    window_s: float
    device: Optional[DeviceTrace]
    start_bytes: List[int] = dataclasses.field(default_factory=list)
