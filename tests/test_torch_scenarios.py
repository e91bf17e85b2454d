"""The port's scenario examples (``examples/torch_*.py``) and benches
(``repro_torch.benchmarks``), each run at a small size on the CPU: every
run's chain valid, the bench's CSV lines printed (``name,us,derived``),
the cohort example's replay of its memberships from the seed.
``bench_kernels`` times the CUDA kernels and must refuse the CPU.
"""
import importlib
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (fixture)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES)


def _bench(name):
    return importlib.import_module(f"repro_torch.benchmarks.{name}")


def _csv_names(out, prefix):
    names = [line.split(",")[0] for line in out.splitlines()
             if line.startswith(prefix) and line.count(",") >= 2]
    for line in out.splitlines():
        if line.startswith(prefix):
            float(line.split(",")[1])      # us_per_call parses
    return names


def _check_cohort(result, out):
    store, hist, ledger = result
    assert ledger.validate_chain() and len(ledger.blocks) == 2
    assert "cohort replay from the seed (topology.cohort_table): exact" in out
    assert store.touched == len({i for h in hist for i in h["cohort"]})


def _check_table(result, out):
    assert all(r["chain_valid"] for r in result.values())


def _check_byzantine(result, out):
    assert out.count("chain valid: True") == 3
    assert set(result) == {"clean", "attacked", "defended", "detection"}


def _check_lazy(result, out):
    assert set(result["lazy_ratio"]) == {0.0, 0.1, 0.2, 0.3}
    assert all(r["chain_valid"] for r in result["lazy_ratio"].values())
    assert len(result["flagged"]) == 3


def _check_allocation(result, out):
    assert all(r["chain_valid"] for r in result["results"])
    assert "closed-form (eq.6) K*=" in out


def _check_bench(prefix, count):
    def check(result, out):
        assert len(_csv_names(out, prefix)) == count, out
        rows = [r for r in result.values()
                if isinstance(r, dict) and "chain_valid" in r]
        assert rows and all(r["chain_valid"] for r in rows)
    return check


def _check_robust(result, out):
    assert len(_csv_names(out, "robust_")) == 16 + 6
    assert all(r["chain_valid"] for key, r in result.items() if "|" in key)
    assert len(result["signflip_strength_sweep"]) == 6


SMALL = ["--device", "cpu"]
FL_SMALL = ["--samples", "8", "--t-sum", "24"]
# (runner, module, argv, check)
SCENARIOS = [
    ("example", "torch_cohort_population",
     ["--enrolled", "500", "--cohort", "4", "--rounds", "2", "--samples",
      "8"], _check_cohort),
    ("example", "torch_gossip_topologies",
     ["--clients", "4", "--samples", "8", "--rounds", "2"], _check_table),
    ("example", "torch_scheduled_gossip",
     ["--clients", "4", "--samples", "8", "--rounds", "3"], _check_table),
    ("example", "torch_byzantine_defense",
     ["--clients", "8", "--samples", "8", "--rounds", "2", "--attackers",
      "2"], _check_byzantine),
    ("example", "torch_lazy_clients",
     ["--clients", "4", "--detect-clients", "4", *FL_SMALL], _check_lazy),
    ("example", "torch_resource_allocation",
     ["--clients", "4", *FL_SMALL], _check_allocation),
    ("bench", "bench_cohort", ["--rounds", "2", "--enrolled", "64", "1000"],
     _check_bench("cohort_C", 2)),
    ("bench", "bench_topology", ["--clients", "4", *FL_SMALL],
     _check_bench("topology_", 4)),
    ("bench", "bench_schedules",
     ["--clients", "5", "--rate-k", "3", *FL_SMALL],
     _check_bench("schedule_", 6)),
    ("bench", "bench_robust",
     ["--clients", "8", "--samples", "8", "--k", "2"], _check_robust),
]


@pytest.mark.parametrize("runner,module,argv,check", SCENARIOS,
                         ids=[s[1] for s in SCENARIOS])
def test_scenario_runs_on_the_cpu(runner, module, argv, check, capsys):
    mod = _example(module) if runner == "example" else _bench(module)
    result = mod.main(argv + SMALL)
    check(result, capsys.readouterr().out)


def test_bench_kernels_refuses_the_cpu():
    bench_kernels = _bench("bench_kernels")
    with pytest.raises(ValueError, match="times the CUDA kernels on the "
                                         "card"):
        bench_kernels.main(["--device", "cpu"])
