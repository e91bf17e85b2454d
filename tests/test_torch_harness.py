"""The port's benchmark harness and the dry-run's readers, on the CPU:
``roofline.round_hot_block_bytes``, ``roofline.table`` and
``gen_experiments.roofline_section`` against the JAX package's on the same
inputs (the reference's record directory monkeypatched, no reference file
edited); ``run.main`` with every bench stubbed against the reference's
``run.main`` so stubbed (its output path monkeypatched): the same result
keys, a failing section recorded and exit 1, ``kernels`` skipped on the
CPU, ``--only`` merging, the reference's record refused; and
``bench_rounds.bench_kernel_path`` at a tiny size.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks import gen_experiments as jgen
from benchmarks import roofline as jroofline
from benchmarks import run as jrun
from repro.models.mlp import init_mlp as jinit_mlp
from repro_torch.benchmarks import (bench_kernels, bench_rounds,
                                    gen_experiments, roofline, run)
from repro_torch.configs import INPUT_SHAPES, arch_ids
from repro_torch.launch import analysis, dryrun
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

PHI4 = "phi4-mini-3.8b"


@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("fused_mix", [False, True])
@pytest.mark.parametrize("fast_allreduce", [False, True])
def test_round_hot_block_bytes_is_the_references(n_devices, fused_mix,
                                                 fast_allreduce):
    for model_bytes, c, attempts in ((4 * 203_530, 20, 1024),
                                     (123.0, 8, 256)):
        kw = dict(n_devices=n_devices, fused_mix=fused_mix,
                  fast_allreduce=fast_allreduce)
        assert roofline.round_hot_block_bytes(model_bytes, c, attempts,
                                              **kw) == \
            jroofline.round_hot_block_bytes(model_bytes, c, attempts, **kw)


@pytest.mark.parametrize("n_devices", [0, 3])
def test_round_hot_block_bytes_refuses_what_the_reference_refuses(n_devices):
    for fn in (roofline.round_hot_block_bytes,
               jroofline.round_hot_block_bytes):
        with pytest.raises(ValueError, match="dividing C=8"):
            fn(1.0, 8, 16, n_devices=n_devices)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A directory of dry-run records: phi4-mini x decode_32k traced on
    each mesh, hubert x decode_32k skipped, and a failed record."""
    d = tmp_path_factory.mktemp("dryrun")
    ok = dryrun.run_pair(PHI4, "decode_32k", False)
    ok2 = dict(ok, mesh="pod2x16x16",
               roofline=dict(ok["roofline"], dominant="collective_s",
                             collective_s=1.0, bound_s=1.0))
    recs = [ok, ok2, dryrun.run_pair("hubert-xlarge", "decode_32k", False),
            {"arch": "qwen3-32b", "shape": "train_4k", "mesh": "pod16x16",
             "status": "failed", "rank": 0,
             "error": "RuntimeError: planted", "traceback": "..."}]
    for r in recs:
        with open(d / f"{r['arch']}__{r['shape']}__{r['mesh']}.json",
                  "w") as f:
            json.dump(r, f)
    return str(d)


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_roofline_rows_are_the_references(records, mesh, monkeypatch,
                                          capsys):
    monkeypatch.setattr(jroofline, "DRYRUN_DIR", records)
    rows = roofline.table(mesh, dryrun_dir=records)
    assert rows == jroofline.table(mesh)
    assert {r["status"] for r in rows} == (
        {"ok", "skipped", "failed"} if mesh == "pod16x16" else {"ok"})
    capsys.readouterr()
    assert roofline.run(mesh, records) == rows
    ours = capsys.readouterr().out
    jroofline.run(mesh)
    assert ours == capsys.readouterr().out


def test_roofline_without_records_names_the_ports_dryrun(tmp_path, capsys):
    assert roofline.run("pod16x16", str(tmp_path)) == []
    assert "python -m repro_torch.launch.dryrun --all --both-meshes" in \
        capsys.readouterr().out


def test_markdown_roofline_rows_are_the_references(records, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(jgen, "DRYRUN_DIR", records)
    gen_experiments.roofline_section(records)
    ours = capsys.readouterr().out.splitlines()
    jgen.roofline_section()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[1:] == theirs[1:]
    assert sum(line.startswith(f"| {PHI4} |") for line in ours) == 1
    for const in (analysis.PEAK_FLOPS_BF16 / 1e12,
                  analysis.PEAK_FLOPS_FP32 / 1e12, analysis.HBM_BW / 1e12,
                  analysis.NVLINK_BW / 1e9):
        assert f"{const:g}" in ours[0]
    assert "v5e" not in ours[0] and "TPU" not in ours[0]


def test_markdown_dryrun_counts(records, capsys):
    gen_experiments.dryrun_section(records)
    out = capsys.readouterr().out
    assert "single-pod (16x16 = 256 GPUs): 1 ok / 1 skipped / 1 failed" \
        in out
    assert "multi-pod (2x16x16 = 512 GPUs): 1 ok / 0 skipped / 0 failed" \
        in out
    assert "| qwen3-32b | train_4k | failed: RuntimeError: planted |" in out
    gen_experiments.main(["--in", records])
    assert capsys.readouterr().out.startswith("## §Dry-run")


def test_archs_and_shapes_are_the_references():
    assert gen_experiments.ARCHS == jgen.ARCHS
    assert gen_experiments.SHAPES == jgen.SHAPES
    assert sorted(gen_experiments.ARCHS) == sorted(arch_ids())
    assert sorted(gen_experiments.SHAPES) == sorted(INPUT_SHAPES)


# every bench the two harnesses call, stubbed
REF_BENCHES = [("bench_kernels", "run"), ("bench_rounds", "bench"),
               ("bench_rounds", "bench_kernel_path"),
               ("bench_topology", "bench"), ("bench_schedules", "bench"),
               ("bench_cohort", "bench"), ("bench_multidevice", "bench"),
               ("bench_hierarchy", "bench"), ("bench_robust", "bench"),
               ("roofline", "run")]
PORT_BENCHES = [("bench_kernels", "bench"), *REF_BENCHES[1:]]


def _stub(name):
    def fn(*args, **kw):
        return {"stub": name}
    return fn


def stub_port(monkeypatch, **raising):
    """Stub every bench of the port's harness; the names in ``raising``
    raise their value."""
    for name in run.PAPER:
        monkeypatch.setitem(run.PAPER, name, _stub(name))
    for mod, fn in PORT_BENCHES:
        monkeypatch.setattr(getattr(run, mod), fn, _stub(f"{mod}.{fn}"))
    for name, exc in raising.items():
        def boom(*args, exc=exc, **kw):
            raise exc
        if name in run.PAPER:
            monkeypatch.setitem(run.PAPER, name, boom)
        else:
            monkeypatch.setattr(getattr(run, name.split(".")[0]),
                                name.split(".")[1], boom)


def reference_keys(monkeypatch, tmp_path, argv):
    """The result keys of the reference's harness with every bench
    stubbed, written to a file under ``tmp_path``."""
    for name in ("fig3_bound_gap", "table2_alpha", "table3_beta",
                 "table4_clients", "table5_eta", "table6_lazy",
                 "table7_sigma", "fig10_dp"):
        monkeypatch.setattr(jrun.paper_tables, name, _stub(name))
    for mod, fn in REF_BENCHES:
        monkeypatch.setattr(getattr(jrun, mod), fn, _stub(f"{mod}.{fn}"))
    out = tmp_path / "reference.json"
    monkeypatch.setattr(jrun, "OUT", str(out))
    monkeypatch.setattr(sys, "argv", ["run", *argv])
    jrun.main()
    with open(out) as f:
        return set(json.load(f))


def run_port(tmp_path, argv, name="port.json"):
    out = tmp_path / name
    code = run.main([*argv, "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        return code, json.load(f)


@pytest.mark.parametrize("argv", [
    [], ["--fast"], ["--only", "fig3,table6"],
    ["--fast", "--only", "fig3,table6,rounds,roofline"],
    ["--only", "kernels,topology,schedules,cohort"],
    ["--only", "table2,table3,table4,table5,table7,fig10"],
    ["--only", "multidevice,hierarchy,robust"]])
def test_harness_keys_are_the_references(argv, monkeypatch, tmp_path):
    stub_port(monkeypatch)
    code, results = run_port(tmp_path, argv)
    assert code == 0
    want = reference_keys(monkeypatch, tmp_path, argv)
    assert set(results) - {"device", "section_s"} == want
    assert set(results["section_s"]) == want
    assert results["device"] == {"card": "cpu", "torch": torch.__version__}


def test_a_failing_section_is_recorded_and_exits_1(monkeypatch, tmp_path):
    stub_port(monkeypatch, table6=ValueError("planted"),
              **{"bench_rounds.bench_kernel_path": RuntimeError("planted")})
    code, results = run_port(
        tmp_path, ["--only", "fig3,table6,rounds,roofline"])
    assert code == 1
    assert results["table6_mnist"] == results["table6_fashion"] == {
        "error": "ValueError: planted"}
    assert results["rounds_kernel_path"] == {"error": "RuntimeError: planted"}
    for key in ("fig3_mnist", "fig3_fashion", "rounds_scan_vs_loop",
                "roofline_pod16x16", "roofline_pod2x16x16"):
        assert "stub" in results[key]


def test_kernels_are_skipped_on_the_cpu(monkeypatch, tmp_path):
    stub_port(monkeypatch, **{"bench_kernels.bench": AssertionError(
        "bench_kernels called on the CPU")})
    code, results = run_port(tmp_path, ["--only", "kernels"])
    assert code == 0 and set(results["kernels"]) == {"skipped"}


def test_only_merges_over_an_existing_out(monkeypatch, tmp_path):
    stub_port(monkeypatch)
    out = tmp_path / "port.json"
    with open(out, "w") as f:
        json.dump({"fig3_mnist": {"kept": 1}, "section_s": {"fig3_mnist": 7}},
                  f)
    code, results = run_port(tmp_path, ["--fast", "--only", "table6"])
    assert code == 0
    assert results["fig3_mnist"] == {"kept": 1}
    assert results["table6_mnist"] == {"stub": "table6"}
    assert set(results["section_s"]) == {"fig3_mnist", "table6_mnist"}


def test_the_references_record_is_refused(monkeypatch, tmp_path):
    stub_port(monkeypatch)
    before = (open(run.REFERENCE_OUT, "rb").read()
              if os.path.exists(run.REFERENCE_OUT) else None)
    for path in (run.REFERENCE_OUT,
                 os.path.join(run.ROOT, "experiments", ".",
                              "bench_results.json")):
        with pytest.raises(SystemExit) as e:
            run.main(["--fast", "--only", "table6", "--device", "cpu",
                      "--out", path])
        assert e.value.code == 2
    after = (open(run.REFERENCE_OUT, "rb").read()
             if os.path.exists(run.REFERENCE_OUT) else None)
    assert before == after


def test_unknown_only_names_are_refused(monkeypatch, tmp_path):
    stub_port(monkeypatch)
    with pytest.raises(SystemExit):
        run_port(tmp_path, ["--only", "fig3,tabel6"])
    assert not (tmp_path / "port.json").exists()


def test_roofline_section_reads_the_dryrun_dir(records, tmp_path):
    code, results = run_port(tmp_path, ["--only", "roofline",
                                        "--dryrun-dir", records])
    assert code == 0
    for mesh in ("pod16x16", "pod2x16x16"):
        assert results[f"roofline_{mesh}"] == roofline.table(mesh, records)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="is_available"):
        run.main(["--only", "roofline"])
    with pytest.raises(RuntimeError, match="is_available"):
        bench_rounds.bench_kernel_path()
    with pytest.raises(ValueError, match="card"):
        bench_kernels.bench("cpu")


def test_kernel_path_tiers_on_the_cpu(monkeypatch):
    finals = {}
    run_blade_fl = bench_rounds.rounds.run_blade_fl

    def recording(loss_fn, spec, *args, **kw):
        state, hist, ledger = run_blade_fl(loss_fn, spec, *args, **kw)
        finals[spec.fused_mix] = state.params
        return state, hist, ledger

    monkeypatch.setattr(bench_rounds.rounds, "run_blade_fl", recording)
    c, attempts = 4, 64
    out = bench_rounds.bench_kernel_path(n_rounds=2, n_clients=c, samples=8,
                                         tau=2, reps=1, mine_attempts=attempts,
                                         device="cpu")
    assert set(out) == {"default", "fused_mix", "note"}
    assert "cpu" in out["note"] and "interpret" not in out["note"]
    ref_bytes = 4 * sum(x.size for x in
                        jax.tree.leaves(jinit_mlp(jax.random.key(0))))
    for name, fused in (("default", False), ("fused_mix", True)):
        tier = out[name]
        assert tier["chain_valid"] is True
        assert tier["rounds_per_s"] > 0 and len(tier["runs_s"]) == 1
        assert tier["wall_s"] == tier["runs_s"][0] > 0
        assert tier["dispatch"]["mix_mode"] == "exec_fedavg"
        assert tier["dispatch"]["driver"] == "loop"
        # the CPU runs the plain versions: no kernel is launched
        assert set(tier["launches"].values()) == {0}
        assert tier["est_hot_block_bytes_per_round"] == \
            jroofline.round_hot_block_bytes(ref_bytes, c, attempts,
                                            fused_mix=fused)["total_bytes"]
    assert out["fused_mix"]["vs_default"] > 0
    for key in finals[False]:
        np.testing.assert_allclose(finals[True][key].numpy(),
                                   finals[False][key].numpy(), rtol=1e-5,
                                   atol=0)
