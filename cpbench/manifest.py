"""Find a cell and everything it names by name: ``BENCHMARK.json`` at the
root of the checkout lists the cells and metrics; a configuration is
``configs/<name>.json``, a mix ``mixes/<name>.json``, a cell's
correctness limits ``limits/<cell>.json``, the plain reference that a
configuration names ``references/<name>.py``, a per-layer metric's
reader ``metrics/<name>.py`` and the runner of the cells on ``n`` chips
``runners/chips_<n>.py``.  Adding any of them adds a file; no file here
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "ModelSpec", "Cell", "load_manifest", "load_cell",
           "load_reader", "load_reference", "load_runner"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The sizes and the training recipe of one configuration file, as
    the benchmark (traffic, weights, reference, FLOP counts) reads
    them."""
    name: str
    reference: str
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    tie: bool
    train: dict

    @classmethod
    def from_file(cls, name: str, cfg: dict) -> "ModelSpec":
        load_reference(cfg["reference"]).check_config(name, cfg)
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(name=name, reference=cfg["reference"],
                   layers=cfg["num_hidden_layers"], d_model=d,
                   heads=h, kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg.get("head_dim", d // h),
                   d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   rope_theta=float(cfg["rope_theta"]),
                   norm_eps=float(cfg["norm_epsilon"]),
                   tie=bool(cfg["tie_word_embeddings"]), train=cfg["train"])

    @property
    def chips(self) -> int:
        mesh = self.train["mesh"]
        return mesh["data"] * mesh["model"]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    spec: ModelSpec
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, mix,
    limits and the metrics it reports."""
    manifest = manifest or load_manifest(here.parent)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfile = here.parent / configs[w["config"]]["file"]
    spec = ModelSpec.from_file(w["config"], json.loads(cfile.read_text()))
    if spec.chips != w["chips"]:
        raise ValueError(f"{name}: config {w['config']} runs on "
                         f"{spec.chips} chips, the cell asks for "
                         f"{w['chips']}")
    mix = json.loads((here / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name)]
    return Cell(name, w["chips"], spec, mix, limits, e2e, per_layer)


def _load(kind: str, name: str, here: Path):
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    mod_name = f"cpbench.{kind}." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _load("metrics", metric, here).read


def load_reference(name: str, here: Path = HERE):
    """The plain reference module ``references/<name>.py``."""
    return _load("references", name, here)


def load_runner(chips: int, here: Path = HERE):
    """The ``run(cell, seed, seconds, trace, t_start)`` function of
    ``runners/chips_<chips>.py``."""
    return _load("runners", f"chips_{int(chips)}", here).run
