"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process (the benchmark's runs do not run this):

  program   the program's job against the reference, one job a seed (the
            lower reading of each number: the largest over the seeds)
  control   the reference with TF32 on, in the program's place, against
            the reference in fp32 (the first ``--control`` seeds)
  half      the reference on half of each client's sequences, the mean
            taken over the rest, in the program's place (a fault; the
            first ``--faults`` seeds)
  altered   the program's job with the winner's nonce altered where the
            mine stage produces it (a fault; the first ``--faults`` seeds)
  partial_digest
            the program's job with the digest sweep's leaf sum taken over
            half of each leaf where it is produced (a fault; the first
            ``--faults`` seeds)

A step that returns its state unchanged reads 1 by ``update_gap``'s
measure and needs no run.

    python3 fl_bench/calibrate.py --workload phi4-8l.fl-job \
        --seeds 12 --base 5000000000 --out chiprun_out/cal.jsonl

Each reading is a JSON line on standard output and in ``--out``; the last
line sums them up: each kind's largest and least value of each number.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=5_000_000_000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from fl_bench import harness

    if not torch.cuda.is_available():
        print("calibrate.py runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    seeds = [args.base + i for i in range(args.seeds)]
    with open(args.out, "w") if args.out else open(os.devnull, "w") as out:
        for line in calibrate(cell, dev, seeds, args.control, args.faults):
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
    return 0


def calibrate(cell, dev, seeds, n_control, n_faults):
    """Yield each reading as a JSON line, then the summary's."""
    import torch

    from fl_bench import check, harness
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    from repro_torch.kernels.pow_hash import ops as pow_ops

    t = cell.traffic
    program = harness.Program(cell, dev)
    seal, sweep = pow_ops.mine_seal, fedavg_ops.digest_div_flat
    loss = cell.family.reference.loss

    def altered_seal(*a, **k):
        metrics, new_hash = seal(*a, **k)
        return {**metrics, "nonce": metrics["nonce"] ^ 1}, new_hash

    def partial(x):
        total, residuals = sweep(x)
        return x[:, : x.shape[1] // 2].sum(), residuals

    partial_sweep = harness.StandIn(sweep, partial)

    def half_loss(w, widths, tokens):
        return loss(w, widths, tokens[: tokens.shape[0] // 2])

    rows = []

    def emit(kind, seed, values):
        rows.append({"kind": kind, "seed": seed, **values})
        return json.dumps(rows[-1])

    def program_job(port, tokens, seed, module=None, attr=None,
                    planted=None):
        """The program's job (with ``module.attr`` planted), its pool let
        go and the allocator's cache emptied before and after, as a run
        lets go of it before its check."""
        torch.cuda.empty_cache()
        old = getattr(module, attr) if module else None
        if module:
            setattr(module, attr, planted)
        try:
            result = program.job(port, tokens, seed)
        finally:
            if module:
                setattr(module, attr, old)
        program.release()
        torch.cuda.empty_cache()
        return result

    def judged(result, want):
        return check.program_numbers(cell, program, result, want)

    for i, seed in enumerate(seeds):
        weights = harness.make_weights(seed, cell, dev)
        port = harness.port_weights(cell, weights)
        tokens = harness.make_batch(seed, 0, cell, t["rounds"], dev)
        result = program_job(port, tokens, seed)
        want = check.reference_job(cell, weights, tokens)
        yield emit("program", seed, judged(result, want))
        if i < n_control:
            got = check.reference_job(cell, weights, tokens, tf32=True)
            yield emit("control", seed, check.numbers(got, want))
        if i < n_faults:
            got = check.reference_job(cell, weights, tokens, loss=half_loss)
            yield emit("half", seed, check.numbers(got, want))
            result = program_job(port, tokens, seed, pow_ops, "mine_seal",
                                 altered_seal)
            yield emit("altered", seed, judged(result, want))
            result = program_job(port, tokens, seed, fedavg_ops,
                                 "digest_div_flat", partial_sweep)
            yield emit("partial_digest", seed, judged(result, want))
        del weights, port, tokens, result, want
        torch.cuda.empty_cache()

    summary = {}
    for kind in ("program", "control", "half", "altered", "partial_digest"):
        mine = [r for r in rows if r["kind"] == kind]
        if mine:
            summary[kind] = {
                k: {"max": max(r[k] for r in mine),
                    "min": min(r[k] for r in mine), "n": len(mine)}
                for k in check.NUMBERS if k in mine[0]}
    yield json.dumps({"summary": summary, "workload": cell.name,
                      "device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"})


if __name__ == "__main__":
    sys.exit(main())
