"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port either: top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast

import pytest

from conftest import REPO
from portbench import harness

BENCH = REPO / "portbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "clair_tpu"}, names
    if "reference" in path.relative_to(BENCH).parts:
        assert names <= {"__future__", "contextlib", "math", "typing", "torch"}, names


def test_guard_names_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "clair_tpu_torch_lookalike", types.ModuleType("x"))
    assert "clair_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "clair_tpu.models", types.ModuleType("clair_tpu.models"))
    assert "clair_tpu" in harness.forbidden_modules()


def test_the_port_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import portbench.kinds.train; "
            "from portbench import harness; print(harness.forbidden_modules())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
