"""The paper's experiment on the port, on the CPU: the K sweep
(``repro_torch.benchmarks.common``) against the JAX package's
``benchmarks/common.py`` on the reference's data and initial model carried
over as numpy, the bound fit on identical results, ``paper_tables`` and
the quickstart at a small size, and the trainer's ``--out-dir``.

Per-K losses and accuracy hold to rtol 1e-4 / atol 1e-5 (``torch_runs``:
fp32 GEMMs in another order over tau * K steps); the bound fit is pure
float64 arithmetic on the same inputs and holds to 1e-12.
"""
import dataclasses
import json
import math
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks import common as jcommon
from repro.core import bounds as jbounds
from repro.launch import train as jtrain
from repro.models.mlp import init_mlp as jinit_mlp
from repro_torch.benchmarks import common, paper_tables
from repro_torch.core import bounds
from repro_torch.launch import train
from repro_torch.weights import batch_from_numpy, params_from_jax
from torch_runs import ATOL, RTOL
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

# a sweep small enough for the CPU: C 4, 16 samples a client, tau 20 / 8 / 4
SWEEP = dict(n_clients=4, samples=16, t_sum=24.0, beta=4.0, eta=0.05)
KS = [1, 2, 3]


@pytest.fixture(scope="module")
def sweeps():
    """(reference results, port results) of one sweep on the reference's
    data and initial model."""
    jsrc = jcommon.build_source(n_clients=SWEEP["n_clients"],
                                samples=SWEEP["samples"])
    ref = jcommon.sweep_k(ks=KS, src=jsrc, **SWEEP)
    src = types.SimpleNamespace(
        eval_data=batch_from_numpy(
            {k: np.asarray(v) for k, v in jsrc.eval_data.items()}, "cpu"))
    batch = batch_from_numpy(
        {k: np.asarray(v) for k, v in jsrc.client_data.items()}, "cpu")
    src.static_batch = lambda: batch
    init = jinit_mlp(jax.random.fold_in(jax.random.key(0), 1))
    params = params_from_jax({k: np.asarray(v) for k, v in init.items()},
                             "cpu")
    got = common.sweep_k(ks=KS, src=src, params=params, device="cpu",
                         **SWEEP)
    return ref, got


@pytest.mark.parametrize("key", ["loss_curve", "final_loss", "eval_loss",
                                 "accuracy", "divergence"])
def test_sweep_matches_the_reference(sweeps, key):
    ref, got = sweeps
    assert [r["k"] for r in got] == [r["k"] for r in ref] == KS
    for r, jr in zip(got, ref):
        assert (r["tau"], r["train_time"], r["mine_time"]) == \
            (jr["tau"], jr["train_time"], jr["mine_time"])
        np.testing.assert_allclose(r[key], jr[key], rtol=RTOL, atol=ATOL,
                                   err_msg=f"K={r['k']} {key}")
        assert r["chain_valid"] and r["driver"] == "loop"


def test_bound_fit_on_identical_results_matches_the_reference(sweeps):
    ref, _ = sweeps
    fit = dict(eta=SWEEP["eta"], alpha=1.0, beta=SWEEP["beta"],
               t_sum=SWEEP["t_sum"])
    jp = jcommon.fit_bound_params(ref, **fit)
    p = common.fit_bound_params(ref, **fit)
    for name, want in dataclasses.asdict(jp).items():
        assert getattr(p, name) == pytest.approx(want, rel=1e-12, abs=0)
    for k in range(1, 6):
        want = jbounds.loss_bound(jp, k)
        got = bounds.loss_bound(p, k)
        assert (math.isinf(want) and got == want) or \
            got == pytest.approx(want, rel=1e-12, abs=0), k


def test_run_once_is_none_when_k_is_infeasible():
    assert common.run_once(k=5, device="cpu", **SWEEP) is None
    assert common.default_ks(24.0, 1.0, 4.0) == [1, 2, 3, 4]
    assert common.default_ks() == [1, 2, 3, 4, 5, 6, 8, 9]


def test_own_draws_give_one_source_and_model_per_seed():
    src, params = common.build_experiment("cpu", n_clients=3, samples=8)
    again = common.build_source("cpu", n_clients=3, samples=8)
    for name, v in src.static_batch().items():
        assert torch.equal(v, again.static_batch()[name])
    assert params["w1"].shape == (784, 256)
    out = common.run_once(k=2, device="cpu", n_clients=3, samples=8,
                          t_sum=24.0, beta=4.0)
    assert out["chain_valid"] and len(out["loss_curve"]) == 2
    assert out["final_loss"] == out["loss_curve"][-1]


@pytest.mark.parametrize("name", sorted(paper_tables.TABLES))
def test_paper_tables_at_a_small_size(name, capsys):
    out = paper_tables.main(["--device", "cpu", "--clients", "4",
                             "--samples", "8", "--t-sum", "15",
                             "--only", name])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"{name}_mnist,")
    summary = json.loads(lines[-1])
    assert summary["chain_valid"] is True
    result = out[name]
    if name == "fig3_bound_gap":
        assert result["bound_above"] and result["driver"] == "loop"
        assert [r["k"] for r in result["rows"]] == [1, 2]


def test_torch_quickstart_on_the_cpu(capsys):
    examples = os.path.join(os.path.dirname(__file__), "..", "examples")
    sys.path.insert(0, examples)
    try:
        import torch_quickstart
    finally:
        sys.path.remove(examples)
    ledger = torch_quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert ledger.validate_chain() and len(ledger.blocks) == 5
    assert "driver: loop" in out and "chain valid: True" in out


def test_out_dir_writes_the_reference_keys(tmp_path, monkeypatch, capsys):
    flags = ["--arch", "mlp", "--k", "2", "--clients", "4", "--t-sum", "24"]
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--out-dir",
                                      str(tmp_path / "ref")])
    jtrain.main()
    train.main(flags + ["--device", "cpu", "--out-dir",
                        str(tmp_path / "port")])
    capsys.readouterr()

    def records(sub):
        lines = (tmp_path / sub / "blade_mlp.jsonl").read_text().splitlines()
        return [json.loads(line) for line in lines]

    ref, got = records("ref"), records("port")
    assert len(got) == len(ref) == 2
    assert [set(r) for r in got] == [set(r) for r in ref]
    assert [r["step"] for r in got] == [0, 1]
    assert all(math.isfinite(r["global_loss"]) for r in got)
