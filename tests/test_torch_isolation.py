"""The port stands alone: no JAX, no reference package, no CUDA at import.

``src/repro_torch`` imports torch and numpy only; it keeps its own copies
of whatever it needs from ``repro``, even of modules that never import
JAX.  Its kernels are built at first use, so every module imports on a
machine without ``nvcc`` or a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f)
                                            & set(FORBIDDEN))
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "tests").glob("_torch_*ranks.py")]
    + [p.relative_to(ROOT) for p in (ROOT / "scripts").glob("*_torch.py")]
    + [p.relative_to(ROOT) for p in (ROOT / "examples").glob("*_torch.py")]
    + [Path("chip_smoke.py"), Path("scripts/cp_grad_check.py"),
       Path("scripts/nccl_allgather_bw.py")]), ids=str)
def test_rank_bodies_and_chip_scripts_import_no_jax(path):
    """What runs in spawned ranks and on the card, and the port's CLIs
    (``scripts/*_torch.py``) and examples (``examples/*_torch.py``),
    import neither JAX nor the reference package."""
    assert not _imported_roots(ROOT / path) & set(FORBIDDEN)


def test_port_clis_are_scanned():
    names = {p.name for p in (ROOT / "scripts").glob("*_torch.py")}
    assert {"flashcheck_torch.py", "autotune_torch.py"} <= names
    examples = {p.name for p in (ROOT / "examples").glob("*_torch.py")}
    assert examples == {f"{n}_torch.py" for n in (
        "quickstart", "plan_explorer", "serve_decode", "train_lm")}


@pytest.mark.parametrize("modules", [
    ["repro_torch.serve", "repro_torch.launch.serve"],
    ["repro_torch.kernels.flash_decode", "repro_torch.models"],
    ["repro_torch.launch.train", "repro_torch.kernels.doc_attention",
     "repro_torch.kernels.ops"],
    ["repro_torch.analysis.plan_check", "repro_torch.analysis.lint",
     "repro_torch.analysis.wire_audit", "repro_torch.autotune",
     "repro_torch.launch.schedule", "repro_torch.planner.reference"],
])
def test_port_imports_without_jax_nvcc_or_a_card(modules):
    """A fresh interpreter with no CUDA toolkit on its path and no
    visible card imports the port and never loads JAX, the reference
    package, or the kernel build."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') or m.endswith('._build')]\n"
            "print('loaded:', bad)\n"
            "assert not bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": "/nonexistent", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
