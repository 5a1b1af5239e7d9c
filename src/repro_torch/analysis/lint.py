"""Layer 3 — AST repo lint (DESIGN.md §Static-analysis; the port's copy
of the reference's ``repro.analysis.lint``, without its Pallas rule
KER001, which reads kernel bodies the port writes in CUDA).

Rules for the failure modes PR review keeps catching by hand:

* **RNG001 / RNG002** (scoped to ``planner/``, ``dispatch/``, and
  ``autotune/``): any unseeded RNG call or set-iteration-order
  dependence breaks the ``(seed, step) -> plan`` replay purity elastic
  recovery relies on — a recovered worker must re-derive byte-identical
  plans, and a tuned config must be cache-stable across processes.
* **DEP001**: imports of the reference's deprecated ``core.*`` planner
  shims (``plan``, ``heuristic``, ``baselines``, ``ilp``, ``plan_exec``)
  under the port's name, ``repro_torch.core.*``, outside that package.
* **HYG001-003**: the hygiene subset mirrored from the ruff config
  (unused imports, mutable default args, shadowed builtins) so the tree
  stays clean even where ruff isn't installed.

Suppression: a trailing ``# noqa`` comment suppresses all rules on that
line; ``# noqa: CODE[,CODE...]`` suppresses specific ones.  Ruff's
``F401`` is honoured as an alias for HYG001 so existing re-export
annotations keep working.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding

__all__ = ["lint_source", "lint_paths", "default_targets"]

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.I)

#: ruff code -> our rule id, so one annotation silences both linters
_ALIASES = {"F401": "HYG001", "B006": "HYG002", "A001": "HYG003",
            "A002": "HYG003"}

_DEPRECATED_CORE = {"plan", "heuristic", "baselines", "ilp", "plan_exec"}

_BUILTIN_SHADOWS = {
    "list", "dict", "set", "str", "int", "float", "bool", "tuple",
    "bytes", "type", "id", "input", "sum", "min", "max", "len", "map",
    "filter", "range", "sorted", "zip", "iter", "next", "hash", "print",
    "open", "eval", "exec", "compile", "object", "slice", "format",
    "repr", "round", "abs", "pow", "vars", "dir", "any", "all",
}


def _noqa_codes(lines: list[str]) -> dict[int, set[str] | None]:
    """line no (1-based) -> suppressed codes (None = all)."""
    out: dict[int, set[str] | None] = {}
    for i, line in enumerate(lines, 1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        if codes is None:
            out[i] = None
        else:
            cs = {c.strip().upper() for c in codes.split(",") if c.strip()}
            out[i] = {_ALIASES.get(c, c) for c in cs}
    return out


def _is_seeded_rng_call(node: ast.Call) -> bool | None:
    """None if not an RNG construction/call; True seeded, False unseeded."""
    fn = node.func
    # random.<fn>(...) on the stdlib module-level (shared, process-global)
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        mod, name = fn.value.id, fn.attr
        if mod == "random":
            if name in ("Random", "SystemRandom"):
                return bool(node.args or node.keywords) \
                    and name != "SystemRandom"
            if name == "seed":
                return True
            return False                      # random.shuffle / random.random
        if mod in ("np", "numpy"):
            return None                       # handled via np.random below
    # np.random.<fn>(...) legacy global generator
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Attribute):
        inner = fn.value
        if isinstance(inner.value, ast.Name) and \
                inner.value.id in ("np", "numpy") and inner.attr == "random":
            if fn.attr == "default_rng":
                return bool(node.args or node.keywords)
            if fn.attr == "seed":
                return True
            return False                      # np.random.shuffle / .rand ...
    # bare default_rng(...) (from numpy.random import default_rng)
    if isinstance(fn, ast.Name) and fn.id == "default_rng":
        return bool(node.args or node.keywords)
    return None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _iter_targets(node: ast.AST):
    """(iterated expression, line) pairs that consume iteration order."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield node.iter, node.lineno
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)):
        for gen in node.generators:
            yield gen.iter, node.lineno
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("list", "tuple", "enumerate") and node.args:
        yield node.args[0], node.lineno


def _rng_rules(tree: ast.AST, path: str) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            seeded = _is_seeded_rng_call(node)
            if seeded is False:
                out.append(Finding(
                    "RNG001", "error", f"{path}:{node.lineno}",
                    "unseeded (or process-global) RNG call — plans must "
                    "replay byte-identically from (seed, step)",
                    hint="thread an explicit np.random.default_rng(seed) "
                         "/ random.Random(seed) through the call"))
        for it, line in _iter_targets(node):
            if _is_set_expr(it):
                out.append(Finding(
                    "RNG002", "error", f"{path}:{line}",
                    "iteration over a set: order is hash-dependent and "
                    "varies across processes",
                    hint="wrap in sorted(...) or use a list/dict"))
    return out


# --------------------------------------------------------------------- #
# DEP001 — deprecated shim imports
# --------------------------------------------------------------------- #
def _dep_rules(tree: ast.AST, path: str) -> list[Finding]:
    norm = path.replace("\\", "/")
    if "/repro_torch/core/" in norm or norm.endswith("repro_torch/core"):
        return []
    out = []
    for node in ast.walk(tree):
        mods: list[tuple[str, int]] = []
        if isinstance(node, ast.Import):
            mods = [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "repro_torch.core":
                mods = [(f"repro_torch.core.{a.name}", node.lineno)
                        for a in node.names]
            else:
                mods = [(node.module, node.lineno)]
        for mod, line in mods:
            parts = mod.split(".")
            if len(parts) >= 3 and parts[:2] == ["repro_torch", "core"] and \
                    parts[2] in _DEPRECATED_CORE:
                out.append(Finding(
                    "DEP001", "error", f"{path}:{line}",
                    f"import of deprecated shim `{mod}`",
                    hint="import from repro_torch.planner.* instead "
                         "(plan_exec -> repro_torch.planner.encode)"))
    return out


# --------------------------------------------------------------------- #
# HYG001-003 — hygiene subset (ruff stand-in)
# --------------------------------------------------------------------- #
def _collect_exports(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "__all__":
                for n in ast.walk(node.value):
                    if isinstance(n, ast.Constant) and \
                            isinstance(n.value, str):
                        names.add(n.value)
    return names


def _hygiene_rules(tree: ast.Module, path: str,
                   source: str) -> list[Finding]:
    out = []
    exported = _collect_exports(tree)

    # HYG001 — unused imports
    imported: list[tuple[str, str, int]] = []   # (binding, display, line)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bind = a.asname or a.name.split(".")[0]
                imported.append((bind, a.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                bind = a.asname or a.name
                imported.append((bind, f"{node.module}.{a.name}"
                                 if node.module else a.name, node.lineno))
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    # names referenced in string annotations / docstring doctests are rare
    # here; a noqa tag covers intentional side-effect imports.
    for bind, display, line in imported:
        if bind not in used and bind not in exported:
            out.append(Finding(
                "HYG001", "error", f"{path}:{line}",
                f"unused import `{display}`",
                hint="remove it, or tag `# noqa: F401` for a deliberate "
                     "re-export / side-effect import"))

    # HYG002 — mutable default args; HYG003 — shadowed builtins
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            args = node.args
            defaults = list(args.defaults) + list(args.kw_defaults)
            for dflt in defaults:
                if isinstance(dflt, (ast.List, ast.Dict, ast.Set)) or (
                        isinstance(dflt, ast.Call)
                        and isinstance(dflt.func, ast.Name)
                        and dflt.func.id in ("list", "dict", "set")):
                    name = getattr(node, "name", "<lambda>")
                    out.append(Finding(
                        "HYG002", "error", f"{path}:{dflt.lineno}",
                        f"mutable default argument in `{name}`",
                        hint="default to None and materialize inside"))
            for a in (*args.args, *args.posonlyargs, *args.kwonlyargs):
                if a.arg in _BUILTIN_SHADOWS:
                    name = getattr(node, "name", "<lambda>")
                    out.append(Finding(
                        "HYG003", "error", f"{path}:{a.lineno}",
                        f"parameter `{a.arg}` of `{name}` shadows a "
                        f"builtin",
                        hint="rename the parameter"))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in _BUILTIN_SHADOWS:
                    out.append(Finding(
                        "HYG003", "error", f"{path}:{node.lineno}",
                        f"assignment shadows builtin `{t.id}`",
                        hint="rename the variable"))
    return out


# --------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------- #
def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one module's source.  ``path`` scopes the path-dependent
    rules (RNG in planner//dispatch//autotune/, DEP outside
    repro_torch/core/) and prefixes locations."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("HYG001", "error", f"{path}:{e.lineno or 0}",
                        f"syntax error: {e.msg}",
                        hint="file does not parse")]
    norm = path.replace("\\", "/")
    findings: list[Finding] = []
    if "/planner/" in norm or "/dispatch/" in norm \
            or "/autotune/" in norm:
        findings += _rng_rules(tree, path)
    findings += _dep_rules(tree, path)
    findings += _hygiene_rules(tree, path, source)

    noqa = _noqa_codes(source.splitlines())
    kept = []
    for f in findings:
        line = 0
        if ":" in f.location:
            tail = f.location.rsplit(":", 1)[-1]
            line = int(tail) if tail.isdigit() else 0
        codes = noqa.get(line, ...)
        if codes is ... or (codes is not None and f.rule not in codes):
            kept.append(f)
    kept.sort(key=lambda f: f.location)
    return kept


def default_targets(root: Path) -> list[Path]:
    """The port's lint closure: every python file under
    src/repro_torch/, the port's scripts (scripts/*_torch.py), its tests
    (tests/test_torch_*.py and their rank bodies, tests/_torch_*.py) and
    chip_smoke.py."""
    out: list[Path] = []
    d = root / "src" / "repro_torch"
    if d.is_dir():
        out.extend(sorted(d.rglob("*.py")))
    for pattern in ("scripts/*_torch.py", "tests/test_torch_*.py",
                    "tests/_torch_*.py", "chip_smoke.py"):
        out.extend(sorted(root.glob(pattern)))
    return out


def lint_paths(paths, root: Path | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        rel = str(p.relative_to(root)) if root and p.is_absolute() else str(p)
        findings += lint_source(p.read_text(), rel)
    return findings
