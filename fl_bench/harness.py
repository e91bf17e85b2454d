"""The general part of the benchmark: a cell's files found by name, the
weights and token batches drawn from the seed, the program's training job,
and the measured window.

The unit of work is one BLADE-FL training job of the port,
``repro_torch.core.rounds.run_blade_fl`` on a ``[K, C, B, S + 1]`` token
stack, as ``repro_torch.launch.train.train_arch`` runs it: on the card the
graph driver takes a warm round, one capture, K - 1 replays, one host
transfer and the ledger. The window runs whole jobs back to back, each from
the set-up's initial model on a fresh batch, until ``--seconds`` have
passed, and lets the last one finish.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import re
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from fl_bench import families, jobs

ROOT = Path(__file__).resolve().parents[1]

# the streams a seed feeds
WEIGHTS, BATCH, JOB = 0, 1, 2
WARM_JOB = 2 ** 31
# floats a chunk of :func:`change_norms` (a bound on its scratch memory)
NORM_CHUNK = 1 << 24


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def family(self):
        """The configuration's family module (``families/<family>.py``)."""
        return families.load(self.config["family"])

    @property
    def job(self):
        """The traffic's kind of job (``jobs/<job>.py``)."""
        return jobs.load(self.traffic["job"])

    @property
    def clients(self) -> int:
        return self.traffic["spec"]["n_clients"]


def _for_cell(entries: List[dict], cell: str) -> List[dict]:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and limits files, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    entry = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = root / "fl_bench"
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic"
                            / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name), root=root)


def metric_reader(cell: Cell, name: str) -> Callable:
    """``read`` of ``fl_bench/metrics/<name>.py``."""
    path = cell.root / "fl_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fl_bench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# Inputs, drawn from the seed on the device
# ---------------------------------------------------------------------------


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 64-bit generator seed for one stream of ``seed``."""
    words = np.random.SeedSequence(int(seed) % 2 ** 64,
                                   spawn_key=(stream, index)) \
        .generate_state(2, np.uint32)
    return int(words[0]) << 32 | int(words[1])


def make_weights(seed: int, cell: Cell, device) -> Dict[str, torch.Tensor]:
    """The initial model in the reference's layout: views of one buffer of
    N(0, 1) draws made on the device in one call, each leaf then scaled as
    its family says (``init_leaf``)."""
    family = cell.family
    shapes = family.reference.leaf_shapes(cell.config)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, WEIGHTS))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        leaf = buf[at:at + size].view(shape)
        at += size
        family.init_leaf(name, leaf)
        out[name] = leaf
    return out


def make_batch(seed: int, job: int, cell: Cell, rounds: int,
               device) -> torch.Tensor:
    """Job ``job``'s tokens ``[K, C, B, S + 1]``, uniform over the vocab."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, BATCH, job))
    t = cell.traffic
    shape = (rounds, cell.clients, t["sequences"], t["seq"] + 1)
    return torch.randint(0, cell.config["vocab"], shape, generator=gen,
                         device=device)


def change_norms(final: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[leaves, C]``: each client's L2 distance of ``final[leaf]`` (``[C,
    ...]``) from ``start[leaf]``, in chunks, summed in float64."""
    rows = []
    for name, p in start.items():
        x = final[name].reshape(final[name].shape[0], -1)
        p = p.reshape(-1)
        acc = torch.zeros(x.shape[0], dtype=torch.float64, device=p.device)
        for i in range(0, p.numel(), NORM_CHUNK):
            d = x[:, i:i + NORM_CHUNK] - p[i:i + NORM_CHUNK]
            acc += d.square().sum(1, dtype=torch.float64)
        rows.append(acc)
    return torch.stack(rows).sqrt()


# ---------------------------------------------------------------------------
# The program under test
# ---------------------------------------------------------------------------


def program_config(cell: Cell):
    """The port's ``ModelConfig`` the configuration file names, with the
    file's ``reduced`` keys; raises where a width differs from the file."""
    config = cell.config
    module, attr = config["port_config"].split(".")
    base = getattr(importlib.import_module(f"repro_torch.configs.{module}"),
                   attr)
    cfg = dataclasses.replace(base, **{k: config[k]
                                       for k in config["reduced"]})
    wrong = cell.family.port_mismatch(cfg, config)
    if wrong:
        raise ValueError(f"the port's {config['port_config']} differs from "
                         f"{config['name']}: {wrong}")
    return cfg


def round_spec_fields(cell: Cell) -> dict:
    """The traffic's ``spec``, refused where it sets a field the job's
    reference does not follow."""
    spec = dict(cell.traffic["spec"])
    extra = sorted(set(spec) - cell.job.JUDGED)
    if extra:
        raise ValueError(f"the {cell.traffic['job']!r} job's reference does "
                         f"not judge {extra}; it follows "
                         f"{sorted(cell.job.JUDGED)}")
    return spec


class StandIn:
    """Calls ``call`` in place of a kernel's wrapper in its module. The
    wrapper counts its launches on itself by its module name
    (``digest_div_flat.launches += 1``), so the stand-in keeps that count
    on the wrapper it replaced, where ``kernels.launch_counts()`` reads
    it."""

    def __init__(self, replaced, call: Callable):
        self._replaced, self._call = replaced, call

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    @property
    def launches(self) -> int:
        return self._replaced.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self._replaced.launches = n


@dataclasses.dataclass
class JobResult:
    history: List[dict]
    blocks: list
    chain_valid: bool
    norms: torch.Tensor        # [leaves, C] distances from the initial model
    graph: Dict[str, float]
    dispatch: Dict[str, str]
    # round -> each leaf's sum over the clients' rows, as the digest sweep
    # returned it (reference leaf names), for the rounds that ran eagerly
    digest_sums: Dict[int, Dict[str, float]]


class Program:
    """The port's BLADE-FL training job on one cell's shapes."""

    def __init__(self, cell: Cell, device: torch.device):
        from repro_torch import kernels
        from repro_torch.core import rounds
        from repro_torch.kernels import _build
        from repro_torch.kernels.fedavg import ops as fedavg_ops
        from repro_torch.models import registry
        from repro_torch import tree

        self.kernels, self.rounds, self.fedavg_ops = kernels, rounds, \
            fedavg_ops
        self.cell, self.device = cell, device
        self.cfg = program_config(cell)
        self.spec = rounds.RoundSpec(**round_spec_fields(cell))
        self.loss_fn = registry.client_losses(self.cfg)
        leaves = cell.family.PORT_LEAVES
        want = {k: tuple(v.shape) for k, v in tree.flatten(
            registry.params_specs(self.cfg, torch.float32)).items()}
        have = {leaves[k]: s for k, s
                in cell.family.reference.leaf_shapes(cell.config).items()}
        if want != have:
            raise ValueError(f"the port's leaves {want} are not the "
                             f"reference's {have}")
        # the digest sweep visits the leaves in the port's sorted order
        by_port = {v: k for k, v in leaves.items()}
        self.fold_order = [by_port[k] for k in sorted(by_port)]
        if device.type == "cuda":
            _build.build_all(["pow_race", "fedavg", "flash_attention",
                              "flash_attention_bwd"])

    def expected_launches(self, n_rounds: int) -> Dict[str, int]:
        """Each kernel's launches in a job of ``n_rounds`` on the card (the
        CPU runs the kernels' plain versions: none)."""
        want = dict.fromkeys(self.kernels.launch_counts(), 0)
        if self.device.type == "cuda":
            cell = self.cell
            want.update(cell.job.launches(
                cell.traffic["spec"], cell.family, cell.config, n_rounds,
                len(self.fold_order)))
        return want

    @contextlib.contextmanager
    def digest_sums(self, sums: list):
        """Keep each leaf sum the digest sweep (``digest_div_flat``)
        returns outside a graph capture, in ``sums``: the tensors it made,
        so that nothing is launched to keep them."""
        ops, sweep = self.fedavg_ops, self.fedavg_ops.digest_div_flat

        def kept(x):
            total, residuals = sweep(x)
            if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
                sums.append(total)
            return total, residuals

        ops.digest_div_flat = StandIn(sweep, kept)
        try:
            yield
        finally:
            ops.digest_div_flat = sweep

    def job(self, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
            seed: int) -> JobResult:
        """One job on ``tokens`` from ``weights`` (the port's layout);
        raises unless it took the expected driver, mix and launches."""
        rounds, n_rounds = self.rounds, tokens.shape[0]
        before = self.kernels.launch_counts()
        sums: list = []
        with self.digest_sums(sums):
            state, history, ledger = rounds.run_blade_fl(
                self.loss_fn, self.spec, weights, {"tokens": tokens},
                n_rounds, seed=seed, device=self.device, stacked=True)
        launches = {k: n - before[k]
                    for k, n in self.kernels.launch_counts().items()}
        dispatch = dict(rounds.LAST_DISPATCH)
        driver = "graph" if self.device.type == "cuda" else "loop"
        mix = self.cell.job.MIX_MODE
        if dispatch.get("driver") != driver \
                or dispatch.get("mix_mode") != mix:
            raise RuntimeError(f"the job ran {dispatch}, not the {driver} "
                               f"driver with the {mix} mix")
        if launches != self.expected_launches(n_rounds):
            raise RuntimeError(f"the job launched {launches}, not "
                               f"{self.expected_launches(n_rounds)}")
        n = len(self.fold_order)
        if not sums or len(sums) % n:
            raise RuntimeError(f"the digest sweep kept {len(sums)} leaf "
                               f"sums, not whole rounds of {n}")
        digest_sums = {
            k: dict(zip(self.fold_order,
                        (float(x) for x in sums[k * n:(k + 1) * n])))
            for k in range(len(sums) // n)}
        norms = change_norms(state.params, weights)
        return JobResult(history=history, blocks=list(ledger.blocks),
                         chain_valid=ledger.validate_chain(), norms=norms,
                         graph=dict(rounds.LAST_GRAPH),
                         dispatch=dispatch, digest_sums=digest_sums)

    def release(self) -> None:
        """Let go of the graph driver's pool (``rounds.release_graphs``), as
        the port asks of a caller whose next run needs the memory the last
        run's graphs hold: the next job's warm round or capture frees it.
        A traffic mix with ``release_between_jobs`` calls it after every
        job: at 8 layers of phi4-mini at C = 2, or of MiniCPM-2B at C = 4,
        a job's warm round does not fit beside the last job's pool."""
        if self.device.type == "cuda":
            self.rounds.release_graphs(self.device)


def port_weights(cell: Cell, weights: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The same tensors under the port's leaf names."""
    leaves = cell.family.PORT_LEAVES
    return {leaves[k]: v for k, v in weights.items()}


# ---------------------------------------------------------------------------
# Set-up and the measured window
# ---------------------------------------------------------------------------


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """What a window ran: its jobs in order, its seconds and each job's on
    the host clock, and the device memory each job found allocated at its
    start and the most it held while it ran (bytes; 0 off the card)."""
    jobs: List[JobResult]
    seconds: float
    job_seconds: List[float]
    start_bytes: List[int]
    peak_bytes: List[int]

    def job_peak_bytes(self) -> int:
        """The most memory a job needed: each job's peak less what the jobs
        before it left allocated (``start_bytes[j] - start_bytes[0]``), the
        largest over the window. What a job leaves behind is the next
        job's start, not its need, so this does not grow with the number
        of jobs a window holds."""
        return max(p - (s - self.start_bytes[0])
                   for p, s in zip(self.peak_bytes, self.start_bytes))


def run_window(program: Program, weights: Dict[str, torch.Tensor], cell: Cell,
               seed: int, seconds: float,
               span: Callable = contextlib.nullcontext) -> Window:
    """Whole jobs back to back, each from ``weights`` on job j's batch (and
    followed by :meth:`Program.release` where the traffic says so), until
    ``seconds`` have passed; the last job finishes. The device's peak
    memory is reset before each job and read after it."""
    t, dev = cell.traffic, program.device
    on_card = dev.type == "cuda"
    jobs, ends, starts, peaks = [], [], [], []
    sync(dev)
    t0 = time.perf_counter()
    while True:
        j = len(jobs)
        ends.append(time.perf_counter())
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            starts.append(torch.cuda.memory_allocated(dev))
        with span("make_batch"):
            tokens = make_batch(seed, j, cell, t["rounds"], dev)
        with span("job"):
            result = program.job(weights, tokens,
                                 stream_seed(seed, JOB, j) % 2 ** 63)
        if t["release_between_jobs"]:
            with span("release"):
                program.release()
        jobs.append(result)
        del tokens
        if on_card:
            peaks.append(torch.cuda.max_memory_allocated(dev))
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    ends.append(time.perf_counter())
    if not on_card:
        starts = peaks = [0] * len(jobs)
    return Window(jobs=jobs, seconds=ends[-1] - t0,
                  job_seconds=[b - a for a, b in zip(ends, ends[1:])],
                  start_bytes=starts, peak_bytes=peaks)


def warm_job(program: Program, weights: Dict[str, torch.Tensor], cell: Cell,
             seed: int) -> JobResult:
    """The set-up's untimed job of ``warm_rounds`` on the cell's shapes."""
    t = cell.traffic
    tokens = make_batch(seed, WARM_JOB, cell, t["warm_rounds"],
                        program.device)
    result = program.job(weights, tokens, 0)
    if t["release_between_jobs"]:
        program.release()
    sync(program.device)
    return result
