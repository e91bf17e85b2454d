"""Serving entry point of the port: prefill a batch of prompts, then batched
greedy decode through the cache (the JAX package's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi4-mini-3.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --size one-h100 --batch 4 \\
      --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-236b --size one-h100 --batch 4 \\
      --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch paligemma-3b --size one-h100 --batch 4 \\
      --prompt-len 2048 --gen 32      # also xlstm-125m, minicpm-2b
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch kimi-k2-1t-a32b --size one-h100 --batch 4 \\
      --prompt-len 2048 --gen 32      # also nemotron-4-15b, qwen3-32b

``--size smoke`` runs the architecture's CPU-test config, ``--size
one-h100`` its published widths on one 80 GB H100 (``configs/<arch>.py``'s
``ONE_H100``): cut in depth to fit for Jamba (8 layers, dense MLPs),
DeepSeek-V2 (4), Qwen3-32B (2), Nemotron-4-15B (16) and phi4-mini (2),
in depth and in its routed experts (192 of 384) for Kimi K2 (2 layers),
whole for xLSTM-125M, PaliGemma-3B and MiniCPM-2B (HuBERT X-Large is
whole too, and encoder-only). Weights are
random, drawn on the device from ``--seed``; the prompts from ``--seed +
1`` (for PaliGemma the prompt is its 256 image-patch embeddings, drawn
N(0, 1), then ``--prompt-len`` - 256 text tokens). The prefill runs the
flash-attention kernel in every attention layer (GQA, MLA, or under the
VLM's prefix-LM mask) and the selective-scan kernel in every Mamba layer;
xLSTM's blocks and decode are plain torch. An encoder-only config
(HuBERT) exits, as the reference's driver does. Times
are host-clock seconds between ``torch.cuda.synchronize()`` calls; the
decode loop keeps its tokens on the device and makes no host sync until
the end. It prints the reference's JSON keys plus ``launches`` (kernel
launches in this run), ``peak_mem_gb`` (``torch.cuda.max_memory_allocated``,
None on the CPU) and ``prefill_dropped_share``, the share of the
prefill's routing choices that the MoE capacity dropped (None without
MoE).
Argmax ties go to the first index, as in JAX. fp32 GEMMs run in full fp32
(TF32 off).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import torch

from repro_torch import kernels
from repro_torch import tree as tree_lib
from repro_torch.configs import (ShapeConfig, get_one_h100_arch,
                                 get_smoke_arch)
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry, transformer

SIZES = ("smoke", "one-h100")


def config_of(args) -> ModelConfig:
    if args.size == "smoke":
        return get_smoke_arch(args.arch)
    return get_one_h100_arch(args.arch)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_loop(params, cfg: ModelConfig, state, tok: torch.Tensor,
                start_pos: int, n_steps: int
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``n_steps`` greedy decode steps from ``tok`` at position
    ``start_pos``. Returns (the new tokens, each [B] on the device; the last
    step's logits). Makes no host sync."""
    generated, logits = [], None
    for i in range(n_steps):
        logits, state = transformer.decode_step(params, cfg, state, tok,
                                                start_pos + i)
        tok = torch.argmax(logits, dim=-1)
        generated.append(tok)
    return generated, logits


def serve(args) -> dict:
    dev = resolve_device(args.device)
    cfg = config_of(args)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    max_len = args.prompt_len + args.gen
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    params = registry.init_model(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    batch = registry.make_prefill_batch(
        torch.Generator(device=dev).manual_seed(args.seed + 1), cfg, shape)
    before = kernels.launch_counts()

    _sync(dev)
    t0 = time.perf_counter()
    drops = []
    logits, state = transformer.prefill(params, cfg, batch, max_len=max_len,
                                        moe_drops=drops)
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    rest, last = decode_loop(params, cfg, state, tok, args.prompt_len,
                             args.gen - 1)
    _sync(dev)
    decode_s = time.perf_counter() - t1
    logits = logits if last is None else last
    gen = torch.stack([tok] + rest, dim=1).cpu()
    after = kernels.launch_counts()
    result = {
        "arch": cfg.name, "batch": args.batch, "prompt_len": args.prompt_len,
        "generated_tokens": gen.numel(), "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tokens_per_s": gen.numel() / max(decode_s, 1e-9),
        "sample": gen[0, :8].tolist(),
        "finite": bool(torch.isfinite(logits).all()),
        "launches": {k: after[k] - before[k] for k in after},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "prefill_dropped_share": (
            sum(int(n) for _, n in drops) / sum(a for a, _ in drops)
            if drops else None),
    }
    print(json.dumps(result, indent=1))
    return result


def serve_on_mesh(cfg: ModelConfig, params, batch, tokens: torch.Tensor,
                  mesh, plan, decode_plan=None, max_len: int = 0,
                  blocks: bool = False) -> dict:
    """One rank's serve on a mesh (``launch.mesh.make_host_mesh``, every
    rank calling it with the same arguments): a prefill of ``batch`` by
    ``steps.build_prefill_step`` under ``plan``, then one decode step by
    ``build_decode_step`` under ``decode_plan`` (default ``plan``) for each
    column of ``tokens`` [B, n] (teacher-forced), the cache holding
    ``max_len`` positions (default prompt + n). ``params``, ``batch`` and
    ``tokens`` are whole, on this rank's device (``batch`` as
    ``transformer.prefill`` takes it: tokens, a VLM's patches and text, or
    the audio encoder's frames with optional ``mask_positions``; an
    encoder-only config takes ``tokens`` [B, 0] and runs the prefill
    alone); the rank cuts its blocks
    (``specs.shard_tree``, copies) and runs on them alone; with
    ``blocks`` ``params`` are already this rank's blocks under the
    plans' param specs (``specs.param_pspecs``, the same under both
    plans), so that the whole model never sits on the rank. Returns this
    rank's blocks of each position's logits (the prefill's last, then each
    step's) and of the final state, their specs (``logits_spec``,
    ``state_specs``), the prefill's and each decode step's ms on the host
    clock (synchronized on the card), the bytes each collective received
    and their transports."""
    from repro_torch.launch import steps
    from repro_torch.sharding import specs

    dev = mesh.device
    b, n = tokens.shape
    prompt = sum(batch[k].shape[1] for k in ("patches", "tokens", "frames")
                 if k in batch)
    max_len = max_len or prompt + n
    pshape = ShapeConfig("mesh_prefill", prompt, b, "prefill")
    dshape = ShapeConfig("mesh_decode", max_len, b, "decode")
    prefill, _, pplan = steps.build_prefill_step(
        cfg, pshape, mesh, False, plan=plan, decode_plan=decode_plan,
        max_len=max_len)
    decode, dplan = prefill, pplan
    if cfg.has_decode:
        decode, _, dplan = steps.build_decode_step(
            cfg, dshape, mesh, False, plan=decode_plan or plan)
    elif n:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    local = params if blocks else tree_lib.tree_map(
        lambda x: x.clone(), specs.shard_tree(params, prefill.in_specs[0],
                                              mesh))
    lbatch = specs.shard_tree(batch, specs.serve_batch_pspecs(pplan, batch),
                              mesh)
    mesh.received_by_axes.clear()
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(local, lbatch)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    received = {"prefill": dict(mesh.received)}
    mesh.received_by_axes.clear()
    out, step_ms = [logits], []
    if n:
        ltokens = specs.shard_leaf(tokens, decode.in_specs[2] + (None,),
                                   mesh)
    for i in range(n):
        t0 = time.perf_counter()
        logits, state = decode(local, state, ltokens[:, i], prompt + i)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        out.append(logits)
    received["decode"] = dict(mesh.received)
    return {"logits": out, "state": state,
            "logits_spec": decode.out_specs[0], "state_specs":
            decode.out_specs[1], "prefill_ms": prefill_ms,
            "decode_ms": step_ms, "received": received,
            "transport": mesh.transport, "plan": dplan}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--size", choices=SIZES, default="smoke")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None):
    serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
