"""Uniform model API over the LM zoo (the JAX package's
``models/registry.py``): init, the training loss, the loss of a
client-stacked model for the round engine, training and prompt batches,
and the abstract shapes of every input of an (arch x input shape) pair.

Init and batches draw from an explicit ``torch.Generator`` on the target
device: at full width the weights are drawn on the card, never copied up
from the host. The draws differ from ``jax.random``'s; tests carry the
reference's params and batches across (``weights.lm_params_from_jax``)
instead.

The abstract-shape helpers (``params_specs``, ``train_batch_specs``,
``prefill_batch_specs``, ``decode_state_specs``, ``decode_input_specs``)
return tensors on the ``meta`` device with the reference's global shapes
and dtypes (tokens int32, as the reference's specs): they allocate
nothing, so they run at full size (kimi-k2-1t, jamba-398b). The params
and the decode state are built by the port's own init under torch's fake
tensor mode, so their tree is the one the model reads.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict[str, Any]:
    return transformer.init_lm(generator, cfg, dtype)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True,
            loss_chunk: int = 0, par=None):
    """(loss, {"ce", "aux"}) of one model on ``batch``
    (``transformer.train_loss``; ``par``: one rank's part of the train
    step on a mesh)."""
    return transformer.train_loss(params, cfg, batch, remat=remat,
                                  loss_chunk=loss_chunk, par=par)


def client_losses(cfg: ModelConfig, remat: bool = False, par=None):
    """The round engine's loss (``core.rounds.LossFn``) of an LM:
    ``losses(params, batch) -> [C]``, with ``params`` the model's flattened
    leaves (``tree.flatten``: path -> ``[C, ...]``) and ``batch`` leaves
    ``[C, m, ...]``. Client c's loss is :func:`loss_fn` of the tree of
    views ``params[path][c]`` on ``batch[name][c]``, the clients in a
    Python loop (where the reference vmaps its loss over the client axis:
    the kernels' wrappers and the in-place writes of the MoE dispatch do
    not run under ``torch.func.vmap``). With ``par`` (the train step on a
    mesh) each leaf is this rank's model block of its clients' params and
    the loss is tensor-parallel, the same on every model rank."""

    def losses(params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        n = next(iter(params.values())).shape[0]
        out = []
        for c in range(n):
            one = tree_lib.unflatten({k: v[c] for k, v in params.items()})
            loss, _ = loss_fn(one, cfg, {k: v[c] for k, v in batch.items()},
                              remat=remat, par=par)
            out.append(loss)
        return torch.stack(out)

    return losses


def _draws(generator: torch.Generator, cfg: ModelConfig):
    dev = generator.device

    def tokens(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return tokens, normal


def make_train_batch(generator: torch.Generator, cfg: ModelConfig,
                     shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """A training batch of ``shape`` on the generator's device, laid out as
    the reference's ``make_train_batch``: for a VLM ``{"patches": [B, P,
    D], "tokens": [B, S - P]}``, for the audio encoder ``{"frames": [B, S,
    D], "mask_positions": [B, S] bool (p 0.08), "targets": [B, S]}``, else
    ``{"tokens": [B, S]}``; normals N(0, 1), tokens uniform int64."""
    b, s = shape.global_batch, shape.seq_len
    tokens, normal = _draws(generator, cfg)
    if cfg.family == "vlm":
        return {"patches": normal(b, cfg.vlm_prefix_len, cfg.d_model),
                "tokens": tokens(b, s - cfg.vlm_prefix_len)}
    if cfg.audio_frontend:
        mask = torch.rand((b, s), generator=generator,
                          device=generator.device) < 0.08
        return {"frames": normal(b, s, cfg.d_model), "mask_positions": mask,
                "targets": tokens(b, s)}
    return {"tokens": tokens(b, s)}


def make_prefill_batch(generator: torch.Generator, cfg: ModelConfig,
                       shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """A prompt batch of S = ``shape.seq_len`` positions on the generator's
    device, as the reference's ``make_prefill_batch`` lays it out: for a
    VLM ``{"patches": [B, P, D] ~ N(0, 1), "tokens": [B, S - P]}`` (P =
    ``cfg.vlm_prefix_len``; S = P gives ``tokens`` [B, 0], S < P raises
    ``ValueError``), for the audio encoder ``{"frames": [B, S, D] ~ N(0,
    1)}``, else ``{"tokens": [B, S]}``; tokens uniform int64."""
    b, s = shape.global_batch, shape.seq_len
    tokens, normal = _draws(generator, cfg)
    if cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        if s < p:
            raise ValueError(f"{cfg.name}: a prompt of {s} positions is "
                             f"shorter than the {p} image patches")
        return {"patches": normal(b, p, cfg.d_model),
                "tokens": tokens(b, s - p)}
    if cfg.audio_frontend:
        return {"frames": normal(b, s, cfg.d_model)}
    return {"tokens": tokens(b, s)}


# ---------------------------------------------------------------------------
# Abstract shapes (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(n) for n in shape), dtype=dtype,
                       device="meta")


def _abstract(build) -> Any:
    """``build()``'s tree of tensors, run under fake tensors, as meta
    tensors of the same shapes and dtypes."""
    with FakeTensorMode():
        tree = build()
    return tree_lib.tree_map(lambda x: _meta(x.shape, x.dtype), tree)


def params_specs(cfg: ModelConfig, dtype=torch.bfloat16,
                 n_clients: int = 1) -> Dict[str, Any]:
    """The params' shapes and dtypes; with a leading client axis ``[C,
    ...]`` when ``n_clients > 1``."""
    p = _abstract(lambda: transformer.init_lm(torch.Generator(), cfg, dtype))
    if n_clients > 1:
        p = tree_lib.tree_map(
            lambda a: _meta((n_clients,) + tuple(a.shape), a.dtype), p)
    return p


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16, n_clients: int = 1
                      ) -> Dict[str, torch.Tensor]:
    """A training batch's shapes; with ``n_clients > 1`` a leading client
    axis ``[C, B / C, ...]`` (clients own disjoint local data)."""
    b, s = shape.global_batch, shape.seq_len
    if b % n_clients != 0:
        raise ValueError(f"global_batch={b} must divide evenly over "
                         f"n_clients={n_clients}")
    lead = (n_clients, b // n_clients) if n_clients > 1 else (b,)
    if cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        return {"patches": _meta(lead + (p, cfg.d_model), dtype),
                "tokens": _meta(lead + (s - p,), torch.int32)}
    if cfg.audio_frontend:
        return {"frames": _meta(lead + (s, cfg.d_model), dtype),
                "mask_positions": _meta(lead + (s,), torch.bool),
                "targets": _meta(lead + (s,), torch.int32)}
    return {"tokens": _meta(lead + (s,), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                        dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A prompt batch's shapes (:func:`make_prefill_batch`'s layout)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        p = cfg.vlm_prefix_len
        return {"patches": _meta((b, p, cfg.d_model), dtype),
                "tokens": _meta((b, s - p), torch.int32)}
    if cfg.audio_frontend:
        return {"frames": _meta((b, s, cfg.d_model), dtype)}
    return {"tokens": _meta((b, s), torch.int32)}


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> Dict[str, Any]:
    """The decode state's shapes (``transformer.init_decode_state``)."""
    return _abstract(lambda: transformer.init_decode_state(
        cfg, batch, max_len, dtype, device="cpu"))


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       dtype=torch.bfloat16) -> Dict[str, Any]:
    """The decode step's inputs: ``token`` [B] int32, the ``state`` at a
    capacity of ``shape.seq_len``, and ``pos``, which the port's decode
    takes as a Python int (the step makes no host sync): its entry is the
    type ``int``, where the reference has a 0-dim int32 array."""
    b, s = shape.global_batch, shape.seq_len
    return {"token": _meta((b,), torch.int32), "pos": int,
            "state": decode_state_specs(cfg, b, s, dtype)}
