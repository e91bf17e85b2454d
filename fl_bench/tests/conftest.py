"""CPU tests of the benchmark (``python -m pytest fl_bench/tests``), and
the ``card`` tests, which run on the H100 and skip elsewhere."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from fl_bench import harness  # noqa: E402

# a smoke configuration of the port (phi4-mini's CPU-test widths) and a
# traffic mix small enough for the CPU
SMOKE_CONFIG = {
    "name": "phi4-mini-smoke", "port_config": "phi4_mini_3_8b.SMOKE",
    "family": "transformer", "reduced": [], "n_layers": 2, "d_model": 256, "n_heads": 4,
    "n_kv_heads": 2, "head_dim": 64, "d_ff": 512, "vocab": 512,
    "mlp": "swiglu", "rope_theta": 10000.0, "norm_eps": 1e-05,
    "tie_embeddings": True}
SMOKE_TRAFFIC = {
    "job": "fedavg",
    "spec": {"n_clients": 2, "tau": 2, "eta": 0.01, "mine_attempts": 256,
             "difficulty_bits": 2, "eval_every": 1},
    "sequences": 2, "seq": 16, "rounds": 2, "warm_rounds": 1,
    "release_between_jobs": False}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA H100 (skips without CUDA)")


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


CELLS = [w["name"] for w in bench()["workloads"]]


def smoke_cell(name=CELLS[0], **traffic) -> harness.Cell:
    """A cell of ``BENCHMARK.json``'s metrics and ``name``'s limits at the
    smoke configuration and traffic; a key of ``traffic`` that the smoke
    ``spec`` holds goes there."""
    real = harness.load_cell(name)
    spec = dict(SMOKE_TRAFFIC["spec"])
    spec.update({k: v for k, v in traffic.items() if k in spec})
    top = {k: v for k, v in traffic.items() if k not in spec}
    return harness.Cell(name="smoke", chips=1, config=dict(SMOKE_CONFIG),
                        traffic={**SMOKE_TRAFFIC, **top, "spec": spec},
                        limits=real.limits, end_to_end=real.end_to_end,
                        per_layer=real.per_layer, root=harness.ROOT)
