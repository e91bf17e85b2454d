"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the reference
imports nothing of the program nor of the rest of the benchmark."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """(top-level name, level) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


SOURCES = sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax(source):
    names = {n for n, level in imported(HERE / source) if level == 0}
    assert not names & FORBIDDEN, source


@pytest.mark.parametrize("source", [s for s in SOURCES
                                    if s.startswith("reference/")])
def test_reference_stands_alone(source):
    for name, level in imported(HERE / source):
        if level == 0:
            assert name in {"__future__", "hashlib", "math", "struct",
                            "typing", "numpy", "torch"}, (source, name)


def test_the_guard_sees_whole_names():
    tree = "import repro_torch.core\nfrom repro import x\nimport jax.numpy\n"
    names = set()
    for node in ast.walk(ast.parse(tree)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names & FORBIDDEN == {"repro", "jax"}


def test_run_names_what_it_finds(monkeypatch):
    import sys
    import types

    import repro_torch  # noqa: F401
    from fl_bench import run

    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert run.loaded_forbidden() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro")
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert run.loaded_forbidden() == []
