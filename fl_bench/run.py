"""Run one cell of the benchmark on the card and print its result line.

    python3 fl_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``, from this file's first line): the
imports, the four kernel libraries the cells launch (built into
``build/repro_torch/`` of the checkout on the first run), the initial
model drawn on the card from the seed, and one untimed job of
``warm_rounds`` rounds on the cell's shapes. Then the window
(``harness.run_window``): whole jobs until ``--seconds`` have passed. With
``--trace 1`` the window runs under the profiler and the line carries the
cell's per-layer metrics, else its end-to-end ones. Once the window has
closed and the peak memory is read, one of its jobs is checked against the
plain reference (``check.py``); each number compared is printed beside its
limit, last on standard error and last in the line (``checks``).

It exits with 2 and prints no result without the card or cards the cell
asks for, and with 3 if JAX or the JAX package is loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _power_limit_w():
    """The card's power limit by ``nvidia-smi`` (None where it reads
    nothing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split("\n")[0]
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def end_to_end(cell, window, setup_s: float) -> dict:
    from fl_bench import counts

    rounds = sum(len(r.history) for r in window.jobs)
    values = {
        "tokens_per_s": counts.round_tokens(cell.traffic) * rounds
        / window.seconds,
        "peak_mem_gb": window.job_peak_bytes() / 1e9,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, window, device_trace) -> dict:
    from fl_bench import harness, trace

    reading = trace.Reading(
        widths=cell.config, traffic=cell.traffic,
        jobs=window.jobs, rounds=sum(len(r.history) for r in window.jobs),
        window_s=window.seconds, device=device_trace,
        start_bytes=window.start_bytes)
    out = {}
    for m in cell.per_layer:
        value = harness.metric_reader(cell, m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, seed: int, seconds: float, traced: bool, device,
            t0: float):
    """(the result line's dict, the checks) of one run of ``cell``."""
    import torch

    from fl_bench import check, harness, trace

    marks = [("imports", time.perf_counter())]
    program = harness.Program(cell, device)
    marks.append(("program", time.perf_counter()))
    weights = harness.make_weights(seed, cell, device)
    port = harness.port_weights(cell, weights)
    sums = [float(v.sum(dtype=torch.float64)) for v in weights.values()]
    marks.append(("weights", time.perf_counter()))
    harness.warm_job(program, port, cell, seed)
    marks.append(("warm_job", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    phases = {name: b - a for (name, b), (_, a)
              in zip(marks, [("", t0)] + marks)}

    # the set-up's garbage collected and what is left kept out of later
    # collections, so that none lands in a job by chance
    gc.collect()
    gc.freeze()
    tracer = trace.Tracer(traced)
    on_card = device.type == "cuda"
    with tracer.profile():
        with tracer.span("window"):
            window = harness.run_window(program, port, cell, seed, seconds,
                                        tracer.span)
    gc.unfreeze()
    peak = max(window.peak_bytes)
    device_trace = trace.read(tracer) if traced else None

    program.release()
    if on_card:
        torch.cuda.empty_cache()
    if sums != [float(v.sum(dtype=torch.float64)) for v in weights.values()]:
        raise RuntimeError("the program wrote into the initial model")
    job = check.checked_job(seed, len(window.jobs))
    values = check.check_job(cell, program, weights, seed, job,
                             window.jobs[job], device)
    correct, checks = check.judge(values, cell.limits)

    metrics = (per_layer(cell, window, device_trace) if traced
               else end_to_end(cell, window, setup_s))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": _power_limit_w() if on_card else None}
    if traced:
        dev.update(busy_s=device_trace.busy_s,
                   window_s=device_trace.window_s)
    result = {"correct": correct, "attempted": len(window.jobs),
              "failed": sum(not r.chain_valid for r in window.jobs),
              "metrics": metrics, "device": dev, "checked_job": job,
              "setup_phases_s": phases, "job_s": window.job_seconds,
              "graph_s": [[r.graph.get("warm_s"), r.graph.get("capture_s")]
                          for r in window.jobs]}
    if traced:
        result["breakdown"] = device_trace.breakdown()
    result["checks"] = checks
    return result, checks


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from fl_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, checks = measure(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T0)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
