"""BLADE-FL integrated round (paper §3.1, Fig. 1) on one device.

One integrated round =
  Step 1  local training: tau full-batch GD iterations per client
          (lazy clients instead plagiarize + add noise, eq. 7)
  Step 2  model broadcast & verification (model digest)
  Step 3  mining: per-client PoW nonce race over a calibrated attempt budget
  Step 4  block validation: the winner's block is hash-linked
  Step 5  local updating: every client adopts the aggregate

The round is composed of five stages, each built once per ``RoundSpec`` by
its ``make_*`` factory, as in the JAX package:

  ``local_train``   Step 1: tau GD iterations per client, all clients at
                    once (``bmm`` over the client axis)
  ``perturb``       Step 1 (lazy, eq. 7) + §6 DP noise on the broadcast set
  ``communicate``   Steps 2+5: digest and divergence in one sweep of the
                    broadcast set, then the FedAvg mix (FullMesh)
  ``mine``          Steps 3+4: PoW race over the client axis + hash link
  ``finalize``      global-loss eval and the next carry

On a GPU the three hot spots run hand-written CUDA kernels: the race
(``kernels/pow_hash``), the mix and the digest/divergence sweep
(``kernels/fedavg``). The digest is in the tolerance tier, like the JAX
package's ``fused_mix``: its leaf sums are associated differently from
``mining.digest_tree``, so the ledger forks deterministically from the JAX
chain while both chains validate. Params and losses do not depend on the
mining outcome, so they stay comparable to the reference.

``run_blade_fl`` drives K rounds in a Python loop. The carry and every
metric stay on the device; the run makes one host transfer at the end and
then rebuilds and validates the ledger (``chain.ledger_from_scan``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation, chain, dp as dp_lib, \
    lazy as lazy_lib, mining
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.pow_hash import ops as pow_ops

Tree = Dict[str, torch.Tensor]
# client-stacked params [C, ...] and batch [C, m, ...] -> per-client loss [C]
LossFn = Callable[[Tree, Tree], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """Static configuration of one integrated round (the paper-path fields
    of the JAX package's ``RoundSpec``)."""
    n_clients: int
    tau: int                    # local GD iterations (eq. 3)
    eta: float                  # learning rate
    n_lazy: int = 0
    sigma2: float = 0.0         # lazy artificial-noise variance
    dp_sigma: float = 0.0       # DP Gaussian mechanism (§6)
    mine_attempts: int = 1024   # calibrated from beta (allocation.mining_iterations)
    difficulty_bits: int = 8
    eval_global_loss: bool = True
    # eval stride: compute global_loss only on rounds with
    # (round_idx + 1) % eval_every == 0 (NaN elsewhere); 1 = every round.
    eval_every: int = 1
    # nonce tile of one CUDA block of the race; results do not depend on it
    mine_chunk: int = 1024


class RoundState(NamedTuple):
    params: Tree                # leading client axis C, on the run's device
    generator: torch.Generator  # CPU generator for the lazy / DP draws
    round_idx: int
    prev_hash: torch.Tensor     # int64 word on the run's device


def init_state(params_single: Tree, n_clients: int,
               generator: torch.Generator) -> RoundState:
    dev = next(iter(params_single.values())).device
    return RoundState(
        params=aggregation.replicate(params_single, n_clients),
        generator=generator,
        round_idx=0,
        prev_hash=mining.as_word(chain.GENESIS_HASH, dev),
    )


def make_local_train(loss_fn: LossFn, spec: RoundSpec):
    """Step 1 stage factory: tau local GD iterations per client, eq. 3.

    Returns ``local_train(params, batch) -> (params, local_losses)``, both
    with a leading client axis. The clients are independent, so the
    gradient of ``sum_c loss_c`` is each client's own gradient. The loss
    returned is the one at the last iteration's pre-update params, as the
    JAX package's ``value_and_grad`` gives it."""

    def local_train(params, batch):
        keys = sorted(params)
        p = [params[k] for k in keys]
        losses = torch.zeros(spec.n_clients, device=p[0].device)
        for _ in range(spec.tau):
            leaves = [w.detach().requires_grad_(True) for w in p]
            with torch.enable_grad():
                losses = loss_fn(dict(zip(keys, leaves)), batch)
                grads = torch.autograd.grad(losses.sum(), leaves)
            p = [w.detach() - spec.eta * g for w, g in zip(leaves, grads)]
        return dict(zip(keys, p)), losses.detach()

    return local_train


def make_perturb(spec: RoundSpec):
    """Step 1 tail stage factory: what each client broadcasts instead of
    its honest model.

    Returns ``perturb(params, generator, lazy_noise=None, dp_noise=None)``:
    lazy clients plagiarize their source client's fresh model and add
    N(0, sigma^2) disguise noise (eq. 7), then every client optionally adds
    §6 DP Gaussian noise. The noise dicts (leaf-shaped standard normals)
    replace the generator's draws when given. With ``n_lazy == 0`` and
    ``dp_sigma == 0`` the stage is the identity."""
    active = spec.n_lazy > 0 or spec.dp_sigma > 0.0

    def perturb(params, generator, lazy_noise=None, dp_noise=None):
        if not active:
            return params
        params = lazy_lib.apply_lazy(params, spec.n_clients, spec.n_lazy,
                                     spec.sigma2, generator, lazy_noise)
        return dp_lib.privatize(params, spec.dp_sigma, generator, dp_noise)

    return perturb


def make_communicate(spec: RoundSpec):
    """Steps 2+5 stage factory (FullMesh): ``communicate(params) ->
    (mixed_params, digest, divergence)``.

    One sweep of each leaf of the broadcast set gives the header digest and
    the pre-mix client divergence (Def. 1); then every client adopts the
    client mean (FedAvg). Both run CUDA kernels on GPU tensors."""

    def communicate(params):
        digest, divergence = fedavg_ops.digest_divergence_tree(params)
        return aggregation.fedavg(params), digest, divergence

    return communicate


def make_mine(spec: RoundSpec):
    """Steps 3+4 stage factory: the PoW race and the hash link.

    Returns ``mine(prev_hash, digest, round_idx) -> (mine_metrics,
    new_hash)``. Every client searches its own salted nonce space from
    ``round_idx * 2**20`` (mod 2**32) over the calibrated attempt budget
    (eq. 1); the winner is the argmin hash across the client axis (first
    index on ties) and its nonce seals the new block onto ``prev_hash``.
    Bitwise equal to the JAX package's stage given the same digest."""

    def mine(prev_hash, digest, round_idx):
        dev = digest.device
        client_ids = torch.arange(spec.n_clients, dtype=torch.int64,
                                  device=dev)
        nonce_offset = torch.full((), (int(round_idx) << 20) & mining.MASK,
                                  dtype=torch.int64, device=dev)
        best_h, best_n = pow_ops.pow_race(
            prev_hash, digest, client_ids, spec.mine_attempts,
            nonce_offset=nonce_offset, chunk=spec.mine_chunk)
        winner = mining.winner_of(best_h)
        # index_select, not best_h[winner]: no device-to-host read
        at = winner.reshape(1)
        pow_hash = best_h.index_select(0, at).reshape(())
        nonce = best_n.index_select(0, at).reshape(())
        solved = pow_hash <= mining.difficulty_threshold(spec.difficulty_bits)
        new_hash = mining.mix_hash(prev_hash, digest, nonce)
        metrics = {"winner": winner, "pow_hash": pow_hash, "nonce": nonce,
                   "solved": solved}
        return metrics, new_hash

    return mine


def make_finalize(loss_fn: LossFn, spec: RoundSpec,
                  n_rounds: Optional[int] = None):
    """Closing stage factory: strided global-loss eval + the next carry.

    Returns ``finalize(state, params, new_hash, batch, metrics) ->
    (RoundState, metrics)``. The global loss is the per-client loss
    ``[C]`` of each post-mix model on its own shard; rounds skipped by the
    ``eval_every`` stride report NaN, and ``n_rounds`` (the horizon) forces
    an eval on the last round. ``run_blade_fl`` averages it on the host."""

    def finalize(state, params, new_hash, batch, metrics):
        if spec.eval_global_loss:
            k = state.round_idx + 1
            is_eval = (spec.eval_every <= 1 or k % spec.eval_every == 0
                       or (n_rounds is not None and k == n_rounds))
            if is_eval:
                with torch.no_grad():
                    metrics["global_loss"] = loss_fn(params, batch)
            else:
                metrics["global_loss"] = torch.full(
                    (spec.n_clients,), float("nan"), device=new_hash.device)
        new_state = RoundState(params=params, generator=state.generator,
                               round_idx=state.round_idx + 1,
                               prev_hash=new_hash)
        return new_state, metrics

    return finalize


def make_integrated_round(loss_fn: LossFn, spec: RoundSpec,
                          n_rounds: Optional[int] = None):
    """Build the round: ``(RoundState, batch) -> (RoundState, metrics)``.

    ``batch`` leaves have a leading client axis [C, local_batch, ...]. The
    round is the composition of the stage factories above."""
    local_train = make_local_train(loss_fn, spec)
    perturb = make_perturb(spec)
    communicate = make_communicate(spec)
    mine = make_mine(spec)
    finalize = make_finalize(loss_fn, spec, n_rounds)

    def round_fn(state: RoundState, batch) -> Tuple[RoundState, Tree]:
        params, local_losses = local_train(state.params, batch)
        params = perturb(params, state.generator)
        params, digest, divergence = communicate(params)
        mine_metrics, new_hash = mine(state.prev_hash, digest,
                                      state.round_idx)
        metrics = {"local_loss": local_losses, **mine_metrics,
                   "digest": digest, "divergence": divergence}
        return finalize(state, params, new_hash, batch, metrics)

    return round_fn


def metrics_to_host(rows: List[Tree]) -> Dict[str, np.ndarray]:
    """Stack K rounds of device metrics and bring them to the host in ONE
    transfer: every field is packed into one float64 vector (int words
    below 2**32, bools and fp32 values are exact in float64), then each is
    cut out and given back its dtype. Returns field -> [K, ...] array."""
    names = list(rows[0])
    stacked = [torch.stack([r[n] for r in rows]) for n in names]
    packed = torch.cat([s.reshape(-1).to(torch.float64) for s in stacked])
    flat = packed.cpu().numpy()
    out, at = {}, 0
    for name, s in zip(names, stacked):
        size = s.numel()
        dtype = {torch.float32: np.float32, torch.bool: np.bool_}.get(
            s.dtype, np.int64)
        out[name] = flat[at:at + size].reshape(tuple(s.shape)).astype(dtype)
        at += size
    return out


def run_blade_fl(loss_fn: LossFn, spec: RoundSpec, params_single: Tree,
                 batch: Tree, n_rounds: int, *, seed: int = 0,
                 device: DeviceLike = "cuda",
                 ledger: Optional[chain.Ledger] = None):
    """Run K integrated rounds; returns (final RoundState, history, ledger).

    ``params_single`` (one model) and ``batch`` (``[C, m, ...]``, reused
    every round: full-batch GD) are moved to ``device``, which defaults to
    the GPU and raises when there is none; pass ``device="cpu"`` to run the
    plain versions of the kernels on the CPU. ``seed`` seeds the CPU
    generator of the lazy / DP draws. Each history entry holds the round's
    mining fields, ``digest``, ``divergence``, ``local_loss_mean`` and
    ``global_loss`` as floats, reduced on the host as in the JAX
    package."""
    if int(n_rounds) < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    dev = resolve_device(device)
    params_single = {k: v.to(dev) for k, v in params_single.items()}
    batch = {k: v.to(dev) for k, v in batch.items()}
    generator = torch.Generator(device="cpu").manual_seed(int(seed))
    state = init_state(params_single, spec.n_clients, generator)
    round_fn = make_integrated_round(loss_fn, spec, n_rounds=int(n_rounds))
    rows = []
    for _ in range(int(n_rounds)):
        state, metrics = round_fn(state, batch)
        rows.append(metrics)
    host = metrics_to_host(rows)   # the one host transfer
    glosses = host.pop("global_loss", None)
    llosses = host.pop("local_loss")
    history = [{name: float(v[k]) for name, v in host.items()}
               for k in range(int(n_rounds))]
    for k in range(int(n_rounds)):
        history[k]["local_loss_mean"] = float(np.mean(llosses[k]))
        if glosses is not None:
            history[k]["global_loss"] = float(np.mean(glosses[k]))
    ledger = chain.ledger_from_scan(
        host["digest"], host["winner"], host["nonce"], host["pow_hash"],
        ledger=ledger)
    return state, history, ledger
