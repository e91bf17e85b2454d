"""End-to-end BLADE-FL trainer of the port.

Runs real integrated rounds (training, lazy clients, attacks, digest, the
topology's mix, mining, ledger), on the GPU by default, either:
  * paper-scale: ``--arch mlp``, the paper's §7 substrate: C clients train
    the 784-256-10 MLP on the Dirichlet-split MNIST proxy for K rounds;
  * arch-scale: ``--arch <LM arch id>``, an arch of the LM zoo trained by
    ``--clients`` clients for ``--rounds`` rounds on synthetic token
    streams (``data/pipeline.py::LMDataSource``), at ``--size smoke`` (the
    arch's CPU-test config, the JAX package's ``run_arch_smoke``) or
    ``--size one-h100`` (the arch's ``ONE_H100`` config: xlstm-125m whole
    at its published widths).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp
  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp --k 2 \\
      --clients 4 --topology random:0.5 --fused-mix --device cpu

It prints the JSON keys of the JAX package's ``launch/train.py::run_mlp``
except ``fast_allreduce`` (the port runs on one device). ``--out-dir DIR``
appends each round's history entry to ``DIR/blade_mlp.jsonl``, as the JAX
package's trainer does.

An arch run prints the JAX package's ``run_arch_smoke`` keys (``arch``,
``rounds``, ``loss_curve``, ``chain_valid``, ``dispatch``, ``wall_s``, the
spectral fields) plus the kernels' ``launches`` and ``peak_mem_gb``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --rounds 2 --clients 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --size one-h100 --clients 4 --per-client 2 --seq 256 --rounds 3 \\
      --lazy 1 --sigma2 1e-4

``--enrolled N`` runs the cohort-sampled population instead (the JAX
package's ``run_cohort``): N enrolled clients, of which a cohort of
``--cohort`` (default 64) drawn by ``--cohort-bias`` takes part in each
round; the device holds only the cohort:

  PYTHONPATH=src python -m repro_torch.launch.train --arch mlp \\
      --enrolled 1000 --cohort 8 --k 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import kernels, tree
from repro_torch.configs import (BladeConfig, ShapeConfig, arch_ids,
                                 get_one_h100_arch, get_smoke_arch)
from repro_torch.core import aggregation, allocation, attacks, rounds, \
    spectral, topology
from repro_torch.data.pipeline import CohortDataSource, FLDataSource, \
    LMDataSource
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models.mlp import init_mlp, mlp_client_losses, mlp_loss
from repro_torch.training.metrics import MetricLogger

SIZES = ("smoke", "one-h100")


def spec_of(blade: BladeConfig, eval_every: int = 1,
            **fields) -> rounds.RoundSpec:
    """The round configuration the paper's budget implies (eqs. 1-3);
    ``fields`` sets the scenario fields (topology, attack, ...)."""
    tau = allocation.tau_from_budget(blade.t_sum, blade.K, blade.alpha,
                                     blade.beta)
    return rounds.RoundSpec(
        n_clients=blade.n_clients, tau=max(tau, 1), eta=blade.eta,
        n_lazy=blade.n_lazy, sigma2=blade.sigma2, dp_sigma=blade.dp_sigma,
        mine_attempts=allocation.mining_iterations(blade.beta),
        difficulty_bits=4, eval_every=eval_every, **fields)


def spectral_fields(spec: rounds.RoundSpec, n_rounds: int, table) -> dict:
    """1 - lambda_2(W) diagnostics of the run's topology or schedule, over
    ``table``, the ``[M, C, C]`` matrices the run mixed with: the
    per-round gap stats and the ergodic (product-matrix) gap."""
    rep = spectral.gap_report(spec.topology, spec.n_clients, n_rounds,
                              matrices=table)
    return {"spectral_gap_mean": rep["gap_mean"],
            "spectral_gap_min": rep["gap_min"],
            "ergodic_gap": rep["ergodic_gap"],
            "predicted_consensus_rate": rep["predicted_consensus_rate"]}


def adversary_fields(args) -> dict:
    """``RoundSpec`` fields of the Byzantine scenario: ``--attack`` (with
    ``--attackers`` adversarial clients) and ``--robust`` (the aggregator
    the resolver parses; ``mean`` keeps the linear mix)."""
    out = {}
    if args.attack:
        out["attack"] = attacks.from_name(args.attack, args.attackers)
    if args.robust:
        out["robust_agg"] = args.robust
    return out


def prepare_mlp(args):
    """Config, round spec, data and initial model of the MLP experiment.
    Data and the initial model are drawn on the CPU from the seed and
    moved to the device, so a seed gives the same inputs on every
    device."""
    dev = resolve_device(args.device)
    blade = BladeConfig(n_clients=args.clients, n_lazy=args.lazy,
                        sigma2=args.sigma2, t_sum=args.t_sum,
                        alpha=args.alpha, beta=args.beta, eta=args.eta,
                        K=args.k, dp_sigma=args.dp_sigma, seed=args.seed)
    spec = spec_of(blade, args.eval_every,
                   topology=topology.from_name(args.schedule
                                               or args.topology),
                   fused_mix=args.fused_mix, **adversary_fields(args))
    gen = torch.Generator(device="cpu").manual_seed(blade.seed)
    src = FLDataSource(gen, blade.n_clients, blade.samples_per_client,
                       blade.dirichlet_alpha, seed=blade.seed, device=dev)
    return blade, spec, src, init_mlp(gen), dev


def train_mlp(args, jit: bool = True):
    """Run the MLP experiment; returns (result dict, final RoundState,
    history). The rounds run on the driver ``rounds.dispatch_plan`` picks;
    ``jit=False`` keeps them in the loop (``result["dispatch"]`` says
    which)."""
    blade, spec, src, params, dev = prepare_mlp(args)
    log = MetricLogger(args.out_dir, "blade_mlp")
    seed = blade.seed + 2
    t0 = time.time()
    # the run's mixing matrices, drawn once: the rounds mix with them and
    # the spectral report reads them
    table = topology.round_table(spec.topology, spec.n_clients, blade.K,
                                 topology.topology_generator(seed))
    state, hist, ledger = rounds.run_blade_fl(
        mlp_client_losses, spec, params, src.static_batch(), blade.K,
        seed=seed, device=dev, topology_matrices=table, jit=jit)
    # final eval on held-out data with the aggregated model
    final = aggregation.aggregate_once(state.params)
    with torch.no_grad():
        loss, metrics = mlp_loss(final, src.eval_data)
    for i, h in enumerate(hist):
        log.log(i, **h)
    result = {
        "K": blade.K, "tau": spec.tau, "final_eval_loss": float(loss),
        "final_eval_acc": float(metrics["accuracy"]),
        "final_global_loss": hist[-1].get("global_loss"),
        "chain_valid": ledger.validate_chain(), "blocks": len(ledger.blocks),
        "devices": 1,
        "dispatch": dict(rounds.LAST_DISPATCH),
        "wall_s": time.time() - t0,
        **spectral_fields(spec, blade.K, table),
    }
    return result, state, hist


def run_mlp(args) -> dict:
    result, _, _ = train_mlp(args)
    print(json.dumps(result, indent=1))
    return result


def prepare_cohort(args, samples=BladeConfig.samples_per_client):
    """Config, round spec at cohort size, cohort schedule, data source and
    initial model of a cohort run, drawn on the CPU from the seed;
    ``samples`` a client (by default the paper's 512)."""
    dev = resolve_device(args.device)
    blade = BladeConfig(n_clients=args.cohort, n_lazy=args.lazy,
                        sigma2=args.sigma2, t_sum=args.t_sum,
                        alpha=args.alpha, beta=args.beta, eta=args.eta,
                        K=args.k, dp_sigma=args.dp_sigma, seed=args.seed,
                        samples_per_client=samples)
    spec = spec_of(blade, args.eval_every,
                   topology=topology.from_name(args.schedule
                                               or args.topology),
                   fused_mix=args.fused_mix, **adversary_fields(args))
    cohort = topology.CohortSchedule.from_spec(args.enrolled, args.cohort,
                                               args.cohort_bias)
    src = CohortDataSource(blade.seed, blade.samples_per_client,
                           blade.dirichlet_alpha, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(blade.seed)
    return blade, spec, cohort, src, init_mlp(gen), dev


def train_cohort(args, samples=BladeConfig.samples_per_client):
    """Run the cohort experiment; returns (result dict, store, history).
    ``result`` has the JAX package's ``run_cohort`` keys."""
    blade, spec, cohort, src, params, dev = prepare_cohort(args, samples)
    log = MetricLogger(args.out_dir, "blade_cohort")
    seed = blade.seed + 2
    t0 = time.time()
    # the intra-cohort matrices at size A, drawn once (see train_mlp)
    table = topology.round_table(spec.topology, spec.n_clients, blade.K,
                                 topology.topology_generator(seed))
    store, hist, ledger = rounds.run_blade_fl_cohort(
        mlp_client_losses, spec, params, src.cohort_batch, blade.K, cohort,
        seed=seed, device=dev, topology_matrices=table)
    # final eval: the aggregate of the last round's cohort
    final = aggregation.aggregate_once(store.gather(hist[-1]["cohort"]))
    with torch.no_grad():
        loss, metrics = mlp_loss(final, src.eval_data)
    for i, h in enumerate(hist):
        log.log(i, **{k: v for k, v in h.items() if k != "cohort"})
    result = {
        "enrolled": args.enrolled, "cohort": args.cohort,
        "cohort_bias": args.cohort_bias, "K": blade.K, "tau": spec.tau,
        "touched": store.touched,
        "store_mb": round(store.materialized_bytes() / 1e6, 3),
        "final_eval_loss": float(loss),
        "final_eval_acc": float(metrics["accuracy"]),
        "final_global_loss": hist[-1].get("global_loss"),
        "chain_valid": ledger.validate_chain(), "blocks": len(ledger.blocks),
        "devices": 1,
        "dispatch": dict(rounds.LAST_DISPATCH),
        "wall_s": time.time() - t0,
        # the intra-cohort mix at size A: the enrolled graph is never built
        **spectral_fields(spec, blade.K, table),
    }
    return result, store, hist


def run_cohort(args) -> dict:
    result, _, _ = train_cohort(args)
    print(json.dumps(result, indent=1))
    return result


def prepare_arch(args, cfg=None):
    """Config, round spec, data source and initial model (flattened leaves,
    ``tree.flatten``) of an LM arch run. The config is ``cfg`` if given,
    else the one ``--arch`` and ``--size`` name. The round is the
    reference's ``run_arch_smoke`` round (tau 2, eta 1e-2, 256 attempts,
    difficulty 2). The model is drawn on the CPU from the seed and moved
    to the device, and the data source draws on the CPU too, so a seed
    gives the same inputs on every device."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = (get_smoke_arch(args.arch) if args.size == "smoke"
               else get_one_h100_arch(args.arch))
    shape = ShapeConfig("smoke", args.seq, args.clients * args.per_client,
                        "train")
    spec = rounds.RoundSpec(
        n_clients=args.clients, tau=2, eta=1e-2, n_lazy=args.lazy,
        sigma2=args.sigma2, mine_attempts=256, difficulty_bits=2,
        eval_every=args.eval_every, microbatches=args.microbatches,
        topology=topology.from_name(args.schedule or args.topology),
        fused_mix=args.fused_mix, **adversary_fields(args))
    src = LMDataSource(cfg, shape, args.clients, seed=args.seed, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    params = {k: v.to(dev) for k, v in
              tree.flatten(registry.init_model(gen, cfg)).items()}
    return cfg, spec, src, params, dev


def train_arch(args, jit: bool = True, cfg=None):
    """Run an LM arch (``cfg``, else the config ``args`` name); returns
    (result dict, final RoundState, history). The ``[K, C, ...]`` token
    streams are one static batch, so on the card ``rounds.dispatch_plan``
    picks the graph driver; ``jit=False`` keeps the rounds in the loop
    (``result["dispatch"]`` says which)."""
    cfg, spec, src, params, dev = prepare_arch(args, cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log = MetricLogger(args.out_dir, "blade_arch")
    seed = args.seed + 2
    table = topology.round_table(spec.topology, spec.n_clients, args.rounds,
                                 topology.topology_generator(seed))
    before = kernels.launch_counts()
    t0 = time.time()
    state, hist, ledger = rounds.run_blade_fl(
        registry.client_losses(cfg), spec, params,
        src.stacked_batches(args.rounds), args.rounds, seed=seed,
        device=dev, stacked=True, topology_matrices=table, jit=jit)
    wall_s = time.time() - t0
    after = kernels.launch_counts()
    for i, h in enumerate(hist):
        log.log(i, **h)
    result = {
        "arch": cfg.name, "rounds": args.rounds,
        "loss_curve": [h["global_loss"] for h in hist],
        "chain_valid": ledger.validate_chain(), "blocks": len(ledger.blocks),
        "devices": 1,
        "dispatch": dict(rounds.LAST_DISPATCH),
        "wall_s": wall_s,
        "launches": {k: after[k] - before[k] for k in after},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        **spectral_fields(spec, args.rounds, table),
    }
    return result, state, hist


def run_arch(args) -> dict:
    result, _, _ = train_arch(args)
    print(json.dumps(result, indent=1))
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mlp",
                    help="mlp (the paper's substrate) or an LM arch id "
                         "(configs.arch_ids)")
    ap.add_argument("--size", choices=SIZES, default="smoke",
                    help="LM arch: its CPU-test config, or its one-H100 "
                         "config (configs.get_one_h100_arch)")
    ap.add_argument("--k", type=int, default=5,
                    help="rounds of the mlp and cohort runs")
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of an LM arch run")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--per-client", type=int, default=2,
                    help="LM arch: sequences a client trains on a round")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM arch: tokens a sequence")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="LM arch: gradient accumulation over this many "
                         "microbatches a local iteration "
                         "(RoundSpec.microbatches)")
    ap.add_argument("--lazy", type=int, default=0)
    ap.add_argument("--sigma2", type=float, default=0.0)
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--t-sum", type=float, default=100.0)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=10.0)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="global-loss eval stride (NaN on skipped rounds)")
    ap.add_argument("--topology", default="full",
                    help="Steps 2+5 mixing: full | ring[:k] | random[:p] | "
                         "partial:n | shift[:s] | cluster:g[:a] "
                         "(core/topology.py)")
    ap.add_argument("--schedule", default=None,
                    help="time-varying topology schedule (overrides "
                         "--topology): rotate[:step] | alt[:k[:m]] | "
                         "snr[:period] (core/topology.py Schedules)")
    ap.add_argument("--attack", default=None,
                    help="Byzantine attack stage on the pre-broadcast "
                         "params: signflip[:scale] | noise[:sigma2[:scale]] "
                         "| alie[:z] | replace[:boost] (core/attacks.py); "
                         "the first --attackers clients are adversarial")
    ap.add_argument("--attackers", type=int, default=1,
                    help="adversarial client count for --attack (first-M "
                         "convention, like --lazy)")
    ap.add_argument("--robust", default=None,
                    help="Byzantine-robust aggregation override: mean | "
                         "median | trimmed[:t] | geomed[:iters] — order "
                         "statistics over the full broadcast set instead "
                         "of the linear mix")
    ap.add_argument("--fused-mix", action="store_true",
                    help="contract dense mixes through the mix_rows_flat "
                         "CUDA kernel (kernels/fedavg) instead of "
                         "torch.matmul; the digest/divergence sweep is "
                         "fused on every path")
    ap.add_argument("--enrolled", type=int, default=0,
                    help="cohort mode (the mlp arch): the enrolled clients, "
                         "of which a cohort of --cohort takes part in each "
                         "round; the device holds only the cohort "
                         "(core/rounds.py run_blade_fl_cohort)")
    ap.add_argument("--cohort", type=int, default=64,
                    help="active cohort size A per round (with --enrolled)")
    ap.add_argument("--cohort-bias", default="uniform",
                    help="cohort sampling weights: uniform | pareto[:alpha] "
                         "| prefix (core/topology.py CohortSchedule)")
    ap.add_argument("--out-dir", default=None,
                    help="append each round's metrics to "
                         "OUT_DIR/blade_mlp.jsonl (blade_cohort.jsonl with "
                         "--enrolled, blade_arch.jsonl for an LM arch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch != "mlp" and args.arch not in arch_ids():
        ap.error(f"unknown --arch {args.arch!r}: mlp or one of "
                 f"{', '.join(arch_ids())}")
    if args.enrolled > 0:
        if args.arch != "mlp":
            ap.error("--enrolled cohort mode runs the mlp substrate")
        run_cohort(args)
    elif args.arch == "mlp":
        run_mlp(args)
    else:
        run_arch(args)


if __name__ == "__main__":
    main()
