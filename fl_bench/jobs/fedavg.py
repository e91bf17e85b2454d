"""The paper's job: FullMesh FedAvg of every client's tau plain
gradient-descent steps, no lazy clients, no noise, attack or detection
(the reference's :mod:`fl_bench.reference.fedavg`). On the card the
program runs the FedAvg kernel for the mix."""
from typing import Dict, Mapping

from fl_bench.reference import fedavg as reference

JUDGED = frozenset({"n_clients", "tau", "eta", "mine_attempts",
                    "difficulty_bits", "eval_every", "eval_global_loss"})
MIX_MODE = "exec_fedavg"


def evaluates(spec: Mapping, k: int, n_rounds: int) -> bool:
    """Round ``k`` computes the global loss: every ``eval_every``-th round
    and the last one (the port's ``rounds.evaluates``)."""
    every = spec.get("eval_every", 1)
    return spec.get("eval_global_loss", True) and (
        every <= 1 or (k + 1) % every == 0 or k + 1 == n_rounds)


def launches(spec: Mapping, family, widths: Mapping, n_rounds: int,
             n_leaves: int) -> Dict[str, int]:
    """A job's launches on the card: a race, a FedAvg and a digest sweep
    of every leaf each round; each client's tau forwards and backwards
    and the evaluating rounds' forwards, each layer's kernels once."""
    c, tau = spec["n_clients"], spec["tau"]
    evals = sum(evaluates(spec, k, n_rounds) for k in range(n_rounds))
    layers = family.attention_layers(widths)
    want = {"pow_race": n_rounds, "fedavg_flat": n_leaves * n_rounds,
            "digest_div_flat": n_leaves * n_rounds}
    for name in family.FORWARD_KERNELS:
        want[name] = layers * c * (tau * n_rounds + evals)
    for name in family.BACKWARD_KERNELS:
        want[name] = layers * c * tau * n_rounds
    return want


def reference_job(weights, widths, tokens, spec: Mapping, loss):
    n_rounds = tokens.shape[0]
    return reference.run_job(
        weights, widths, tokens, spec["tau"], spec["eta"], loss,
        [evaluates(spec, k, n_rounds) for k in range(n_rounds)])
