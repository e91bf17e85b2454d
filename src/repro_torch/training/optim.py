"""Optimizers and learning-rate schedules over trees of tensors (the JAX
package's ``training/optim.py``, which uses no optax): SGD (+ momentum),
Adam/AdamW, and the MiniCPM WSD (warmup-stable-decay) schedule
[arXiv:2404.06395] of minicpm-2b's recipe.

Each optimizer is an ``(init, update)`` pair: ``update(grads, state,
params, step) -> (new_params, new_state)``, with ``step`` an int or an
integer tensor. The schedules compute in float32 tensors, as the
reference's do, and take the step as an int or a tensor (on the card a
tensor keeps the update free of host syncs). Nothing is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        eta = lr_fn(step)
        if momentum == 0.0:
            return tree_map(lambda w, g: w - eta * g.to(w.dtype), params,
                            grads), state
        state = tree_map(lambda m, g: momentum * m + g.to(m.dtype), state,
                         grads)
        return tree_map(lambda w, m: w - eta * m.to(w.dtype), params,
                        state), state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        eta = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        mhat_scale = 1.0 / (1 - torch.pow(b1, t))
        vhat_scale = 1.0 / (1 - torch.pow(b2, t))

        def step_fn(w, m_, v_):
            upd = (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + eps)
            if weight_decay:
                upd = upd + weight_decay * w.to(torch.float32)
            return (w.to(torch.float32) - eta * upd).to(w.dtype)

        return tree_map(step_fn, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, floor: float = 0.1):
    """MiniCPM warmup-stable-decay: linear warmup, then constant, then an
    exponential decay 10x down over ``decay_steps``, held at ``floor``."""

    def lr(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        in_decay = step > (warmup_steps + stable_steps)
        t = torch.clamp(step - warmup_steps - stable_steps, min=0.0)
        decay = peak_lr * torch.clamp(
            torch.exp(-t / max(decay_steps, 1) * 2.3026), min=floor)
        return torch.where(step < warmup_steps, warm,
                           torch.where(in_decay, decay,
                                       torch.full_like(step, peak_lr)))

    return lr


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def recipe_for(arch_name: str, peak_lr: float = 3e-4,
               total_steps: int = 1000) -> Optimizer:
    """The arch's default recipe: AdamW under WSD for minicpm (its paper's
    schedule), under the cosine schedule otherwise."""
    if arch_name.startswith("minicpm"):
        return adamw(wsd_schedule(peak_lr, total_steps // 10,
                                  int(total_steps * 0.7), total_steps // 5))
    return adamw(cosine_schedule(peak_lr, total_steps // 10, total_steps))
