"""How ``correct`` is decided: one of the window's jobs, drawn from the
seed, against the plain reference (``fl_bench/reference``) run on the same
weights and tokens once the window has closed.

Five numbers, each with a limit of its own (``limits/<cell>.json``, which
records the readings each limit was set from):

  loss_gap        the widest gap, over the job's rounds, between the
                  program's and the reference's local and global losses
                  (nats)
  update_gap      the worst leaf's gap between the norms of the program's
                  change of the model over the job (every client's row) and
                  the reference's, over the larger of that leaf's reference
                  norm and the median leaf's; a leaf whose reference change
                  is under a thousandth of the median leaf's is left out
  divergence_gap  the widest relative gap, over the rounds, between the
                  clients' divergences before the average
  digest_gap      the widest gap, over the leaves of the rounds the program
                  ran outside a graph (the warm round on the card), between
                  the leaf sums its digest sweep returned and the
                  reference's sums of the clients' trained rows, over the
                  reference's sum of their magnitudes
  mine_mismatch   rounds whose winner, nonce or proof-of-work hash differ
                  from the race recomputed from the program's digest and
                  chain, or whose ledger block or link differs, or whose
                  digest is not the fold of the leaf sums the sweep
                  returned (exact: 0)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fl_bench import harness
from fl_bench.reference import chain as ref_chain

NUMBERS = ("loss_gap", "update_gap", "divergence_gap", "digest_gap",
           "mine_mismatch")
# a leaf whose reference change is below this share of the median leaf's
# moved by rounding alone
STILL_LEAF = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 matrix products with TF32 on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass
class Reading:
    """What a job gave, in the reference's terms: per-round lists
    (``local_loss``, ``global_loss``, ``divergence``), the ``[leaves, C]``
    change norms, and round -> leaf -> sum of the digest sweep."""
    rounds: Dict[str, List[float]]
    norms: torch.Tensor
    digest: Dict[int, Dict[str, float]]


@dataclasses.dataclass
class Reference(Reading):
    magnitudes: Dict[int, Dict[str, float]] = None


def reference_job(cell: harness.Cell, weights: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, tf32: bool = False,
                  loss: Optional[Callable] = None) -> Reference:
    """The reference's job; ``tf32`` runs it a precision lower (the
    control), ``loss`` in place of the family's (a planted fault)."""
    with precision(tf32):
        out, final = cell.job.reference_job(
            weights, cell.config, tokens, cell.traffic["spec"],
            loss or cell.family.reference.loss)
    norms = harness.change_norms({k: v[None] for k, v in final.items()},
                                 weights)
    return Reference(
        rounds={k: out[k] for k in ("local_loss", "global_loss",
                                    "divergence")},
        norms=norms,
        digest={k: {n: s for n, (s, _) in d.items()}
                for k, d in enumerate(out["digest"])},
        magnitudes={k: {n: m for n, (_, m) in d.items()}
                    for k, d in enumerate(out["digest"])})


def program_reading(result: harness.JobResult) -> Reading:
    h = result.history
    return Reading(
        rounds={"local_loss": [r["local_loss_mean"] for r in h],
                "global_loss": [r["global_loss"] for r in h],
                "divergence": [r["divergence"] for r in h]},
        norms=result.norms, digest=result.digest_sums)


def _gap(got: float, want: float) -> float:
    """|got - want|; a value where the reference has none (or none where
    it has one) is infinitely far."""
    if math.isnan(want) or math.isnan(got):
        return 0.0 if math.isnan(want) and math.isnan(got) else math.inf
    return abs(got - want)


def numbers(got: Reading, want: Reference) -> Dict[str, float]:
    """``loss_gap``, ``update_gap``, ``divergence_gap`` and ``digest_gap``
    of a job that gave ``got`` against the reference's ``want``."""
    loss_gap = max(_gap(g, w) for key in ("local_loss", "global_loss")
                   for g, w in zip(got.rounds[key], want.rounds[key]))
    div_gap = max(_gap(g, w) / w for g, w in
                  zip(got.rounds["divergence"], want.rounds["divergence"]))
    w_norm = want.norms.double().cpu()[:, 0]
    g_norm = got.norms.double().cpu()
    median = float(w_norm.median())
    kept = w_norm >= STILL_LEAF * median
    scale = torch.clamp(w_norm, min=median)[:, None]
    gaps = ((g_norm - w_norm[:, None]).abs() / scale)[kept]
    digest_gap = max((abs(s - want.digest[k][n]) / want.magnitudes[k][n]
                      for k, sums in got.digest.items()
                      for n, s in sums.items()), default=math.nan)
    return {"loss_gap": float(loss_gap), "update_gap": float(gaps.max()),
            "divergence_gap": float(div_gap),
            "digest_gap": float(digest_gap)}


def mine_mismatch(cell: harness.Cell, result: harness.JobResult,
                  fold_order: List[str]) -> int:
    bad = ref_chain.check_job(result.history, result.blocks, cell.clients,
                              cell.traffic["spec"]["mine_attempts"])
    for k, sums in result.digest_sums.items():
        folded = ref_chain.fold_digest([sums[n] for n in fold_order])
        bad += folded != int(result.history[k]["digest"])
    return bad + (not result.chain_valid)


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, ``{name: {"value", "limit"}}``): every number at most its
    limit (a NaN fails)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def checked_job(seed: int, n_jobs: int) -> int:
    """The window's job the check replays, drawn from the seed."""
    return int(np.random.default_rng(harness.stream_seed(seed, 3))
               .integers(n_jobs))


def program_numbers(cell: harness.Cell, program: harness.Program,
                    result: harness.JobResult,
                    want: Reference) -> Dict[str, float]:
    values = numbers(program_reading(result), want)
    values["mine_mismatch"] = mine_mismatch(cell, result,
                                            program.fold_order)
    return values


def check_job(cell: harness.Cell, program: harness.Program,
              weights: Dict[str, torch.Tensor], seed: int, job: int,
              result: harness.JobResult, device) -> Dict[str, float]:
    """The five numbers of the window's job ``job`` (its result) against
    the reference run on the same weights and job j's tokens."""
    tokens = harness.make_batch(seed, job, cell, cell.traffic["rounds"],
                                device)
    return program_numbers(cell, program, result,
                           reference_job(cell, weights, tokens))
