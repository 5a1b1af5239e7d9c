"""Nothing the chip runs imports ``jax`` or the JAX package ``repro``
(top-level names compared whole: the port's ``repro_torch`` begins with
``repro``), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from cpbench.run import forbidden_loaded

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_in_what_the_chip_runs(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", [HERE / "reference.py", HERE / "check.py",
                                  HERE / "flops.py", HERE / "traffic.py",
                                  HERE / "samplers.py",
                                  *(HERE / "references").glob("*.py")],
                         ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert not _imports(path) & (JAX | {"repro_torch"})
    assert "port" not in {n.module for n in ast.walk(ast.parse(
        path.read_text())) if isinstance(n, ast.ImportFrom) and n.module}


def test_whole_names_are_compared():
    assert forbidden_loaded(["repro_torch", "repro_torch.models"]) == []
    assert forbidden_loaded(["repro.core.plan", "jaxlib", "numpy"]) == \
        ["jaxlib", "repro"]


def test_a_run_process_loads_no_jax():
    code = ("import cpbench.run as r, cpbench.control, cpbench.port as p;"
            "p.import_port();"
            "import repro_torch.launch.steps, repro_torch.launch.train;"
            "print(r.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
