"""The harness finds each piece by name, a new cell is files and entries
alone, and BENCHMARK.json and the result line keep their schema."""
import json
import re
import shutil

import pytest
import torch

from fl_bench import check, harness, run, trace
from fl_bench.tests.conftest import CELLS, ROOT, bench, smoke_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert set(c.limits) >= set(check.NUMBERS)
    assert {m["name"] for m in c.end_to_end} == {
        "tokens_per_s", "peak_mem_gb", "setup_s"}
    assert len(c.per_layer) == 9
    for m in c.per_layer:
        assert callable(harness.metric_reader(c, m["name"]))
    assert harness.program_config(c).n_layers == c.config["n_layers"]
    assert c.family.__name__ == "fl_bench.families.transformer"
    assert c.job.__name__ == "fl_bench.jobs.fedavg"
    assert set(c.traffic["spec"]) <= c.job.JUDGED


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell")


def test_port_config_drift_refused():
    cell = harness.load_cell(CELLS[0])
    cell.config = dict(cell.config, d_ff=4096)
    with pytest.raises(ValueError):
        harness.program_config(cell)


@pytest.mark.parametrize("field,value", [("n_lazy", 1), ("sigma2", 1e-4),
                                         ("fused_mix", True)])
def test_spec_the_reference_does_not_judge_refused(field, value):
    cell = smoke_cell()
    cell.traffic["spec"][field] = value
    with pytest.raises(ValueError, match=field):
        harness.Program(cell, torch.device("cpu"))


def test_job_peak_leaves_out_what_earlier_jobs_left():
    """Each job's peak less the growth of its start since the first job's:
    a window of more jobs that each leave 67 MB behind reads the same."""
    def window(n):
        starts = [10_000 + 67 * j for j in range(n)]
        return harness.Window(jobs=[], seconds=1.0, job_seconds=[],
                              start_bytes=starts,
                              peak_bytes=[s + 500 for s in starts])
    assert window(4).job_peak_bytes() == window(7).job_peak_bytes() == 10_500
    w = window(3)
    w.peak_bytes[1] += 40
    assert w.job_peak_bytes() == 10_540


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_reader_untraced_reads_nothing(metric):
    c = harness.load_cell(CELLS[0])
    reading = trace.Reading(widths=c.config, traffic=c.traffic, jobs=[],
                            rounds=0, window_s=1.0, device=None)
    assert harness.metric_reader(c, metric)(reading) is None


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A cell, a traffic mix and a per-layer metric added by new files and
    new entries only; every file that was there is left as it was."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fl_bench", tmp_path / "fl_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "fl_bench").rglob("*")
              if p.is_file()}
    here = tmp_path / "fl_bench"
    (here / "traffic" / "fl-job.long.json").write_text(json.dumps(
        {**json.loads((here / "traffic" / "fl-job.c2.json").read_text()),
         "sequences": 1, "seq": 4096}))
    (here / "limits" / "phi4.long-ctx.json").write_text(
        (here / "limits" / f"{CELLS[0]}.json").read_text())
    (here / "metrics" / "rounds_read.py").write_text(
        "def read(r):\n    return float(r.rounds)\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = doc["workloads"][0]["config"]
    doc["workloads"].append({"name": "phi4.long-ctx",
                             "config": config,
                             "traffic": "fl-job.long", "chips": 1,
                             "why": "one long sequence a client"})
    doc["per_layer"].append({"name": "rounds_read", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "round driver", "moves": "tokens_per_s",
                             "workloads": ["phi4.long-ctx"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = harness.load_cell("phi4.long-ctx", root=tmp_path)
    assert cell.traffic["seq"] == 4096
    assert cell.config == harness.load_cell(CELLS[0]).config
    assert [m["name"] for m in cell.per_layer][-1] == "rounds_read"
    reading = trace.Reading(widths=cell.config, traffic=cell.traffic,
                            jobs=[], rounds=3, window_s=1.0, device=None)
    assert harness.metric_reader(cell, "rounds_read")(reading) == 3.0
    assert "rounds_read" not in [
        m["name"] for m in harness.load_cell(CELLS[0],
                                             root=tmp_path).per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_benchmark_json_schema():
    doc = bench()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["fl_bench"]
    assert 1 <= doc["run_seconds"] <= 51
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    configs = {c["name"]: c for c in doc["configs"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fl_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "fl_bench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(doc["workloads"])
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "fl_bench" / "metrics" / f"{m['name']}.py").is_file()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in doc[key]]
    assert len(names) == len(set(names))
    for x in doc["configs"] + doc["workloads"]:
        assert NAME.match(x["name"]) and 1 <= len(x["why"]) <= 200
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced):
    cell = smoke_cell()
    result, checks = run.measure(cell, 2 ** 31 + 77, 0.01, traced,
                                 torch.device("cpu"), 0.0)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {"tokens_per_s", "peak_mem_gb",
                                        "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_run_refuses_without_the_card(capsys):
    assert not torch.cuda.is_available()
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_trace_reading_of_events():
    """Busy time is the union of the device's intervals inside the window;
    a gap takes the innermost harness span around its middle."""
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "fl_bench.window",
         "ts": 0.0, "dur": 10 * us},
        {"ph": "X", "cat": "user_annotation", "name": "fl_bench.job",
         "ts": 1.5 * us, "dur": 7.5 * us},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 2 * us, "dur": 2 * us},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 3 * us, "dur": 2 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 9.5 * us,
         "dur": 1 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 10 * us},
    ]
    t = trace.from_events(events)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(3.5)
    assert t.seconds("^a$") == pytest.approx(2.0)
    assert t.gaps[0] == ("job", pytest.approx(4.5))
    assert t.gaps[1] == ("window", pytest.approx(2.0))
    assert sum(s for _, s in t.gaps) == pytest.approx(6.5)


def test_new_job_kind_and_family_are_files(tmp_path, monkeypatch):
    """A kind of job and a model family are modules found by the names a
    traffic file and a configuration file give (``jobs/<job>.py``,
    ``families/<family>.py``): new ones are new files."""
    from fl_bench import families, jobs

    (tmp_path / "jobs").mkdir()
    (tmp_path / "families").mkdir()
    (tmp_path / "jobs" / "fedavg_copy.py").write_text(
        "from fl_bench.jobs.fedavg import *  # noqa: F401,F403\n"
        "from fl_bench.jobs.fedavg import JUDGED, MIX_MODE  # noqa: F401\n")
    (tmp_path / "families" / "transformer_copy.py").write_text(
        "from fl_bench.families.transformer import *  # noqa: F401,F403\n"
        "from fl_bench.families.transformer import PORT_LEAVES, "
        "reference  # noqa: F401\n")
    monkeypatch.setattr(jobs, "__path__",
                        [*jobs.__path__, str(tmp_path / "jobs")])
    monkeypatch.setattr(families, "__path__",
                        [*families.__path__, str(tmp_path / "families")])
    cell = smoke_cell(job="fedavg_copy")
    cell.config = dict(cell.config, family="transformer_copy")
    assert cell.job.__name__ == "fl_bench.jobs.fedavg_copy"
    assert cell.family.__name__ == "fl_bench.families.transformer_copy"
    result, _ = run.measure(cell, 2 ** 31 + 78, 0.01, False,
                            torch.device("cpu"), 0.0)
    assert result["correct"] is True
