"""TrainState for the centralized (non-FL) training path (the JAX
package's ``training/train_state.py``): the baseline the paper compares
against, and the generic fine-tune step for the LM zoo."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.training.optim import Optimizer


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-dim int32, on the params' device


def create(params, optimizer: Optimizer) -> TrainState:
    dev = tree_lib.leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``; grads a tree like ``params`` (zero for a leaf the loss does
    not read, as JAX's ``grad`` gives it)."""
    flat = tree_lib.flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_lib.unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
    grads = tree_lib.unflatten(dict(zip(leaves, grads)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    microbatches: int = 1):
    """The centralized step: the gradient of the mean loss, then the
    optimizer's update. ``loss_fn(params, batch) -> (loss, metrics)``.
    With ``microbatches > 1`` the batch splits along its first axis into
    that many equal microbatches, run one after another, whose losses and
    gradients are averaged (the metrics are then ``{}``, as in the
    reference). Returns ``step_fn(state, batch) -> (state, {"loss",
    "grad_norm", **metrics})``."""

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        if microbatches > 1:
            n = tree_lib.leaves(batch)[0].shape[0]
            if n % microbatches:
                raise ValueError(f"a batch of {n} does not split into "
                                 f"{microbatches} microbatches")
            size = n // microbatches
            loss, grads = 0.0, None
            for j in range(microbatches):
                mb = tree_lib.tree_map(
                    lambda x: x[j * size:(j + 1) * size], batch)
                l_j, _, g_j = _value_and_grad(loss_fn, state.params, mb)
                loss = loss + l_j
                grads = g_j if grads is None else tree_lib.tree_map(
                    torch.add, grads, g_j)
            loss = loss / microbatches
            grads = tree_lib.tree_map(lambda g: g / microbatches, grads)
            metrics = {}
        else:
            loss, metrics, grads = _value_and_grad(loss_fn, state.params,
                                                   batch)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_lib.leaves(grads)))
        out = {"loss": loss, "grad_norm": gnorm, **metrics}
        return TrainState(params, opt_state, state.step + 1), out

    return step_fn
