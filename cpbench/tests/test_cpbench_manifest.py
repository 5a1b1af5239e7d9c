"""``BENCHMARK.json`` against the benchmark contract's rules of form, and
every name it holds found by its files."""

import json
import re
from pathlib import Path

import pytest

from cpbench.manifest import (ROOT, load_cell, load_manifest, load_reader,
                              load_runner)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|experts_per_tok|top_k)")

MANIFEST = load_manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    rs, cells = MANIFEST["run_seconds"], 24
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key], key


def test_workloads():
    pairs = set()
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported & e2e) >= 2
        assert cell.per_layer


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_its_reader():
    for m in MANIFEST["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_cells_find_their_files():
    for w in MANIFEST["workloads"]:
        cell = load_cell(w["name"])
        assert cell.chips == cell.spec.chips
        assert cell.mix["context_len"] > 0
        assert set(cell.limits["limits"]) == {"loss_gap", "grad_gap",
                                              "change_gap"}


def test_a_new_cell_is_new_files_only(tmp_path):
    """A cell, a config, a mix and a metric added as files are found
    without an edit to any file that is there."""
    here = tmp_path / "cpbench"
    for sub in ("configs", "mixes", "limits", "metrics", "references",
                "runners"):
        (here / sub).mkdir(parents=True)
    src = Path(__file__).resolve().parents[1]
    (here / "references" / "dense_decoder.py").write_text(
        (src / "references" / "dense_decoder.py").read_text())
    cfg = json.loads((src / "configs" / "starcoder2_3b_e32.json").read_text())
    (here / "configs" / "other.json").write_text(json.dumps(cfg))
    mix = json.loads((src / "mixes" / "pile.json").read_text())
    mix["context_len"] = 8192
    (here / "mixes" / "short8k.json").write_text(json.dumps(mix))
    (here / "limits" / "other.short8k.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (here / "metrics" / "zero_free.py").write_text(
        "def read(run):\n    return 1.5\n")
    manifest = {
        "configs": [{"name": "other", "file": "cpbench/configs/other.json"}],
        "workloads": [{"name": "other.short8k", "config": "other",
                       "traffic": "short8k", "chips": 1}],
        "end_to_end": MANIFEST["end_to_end"],
        "per_layer": [{"name": "zero_free", "unit": "ms"}]}
    cell = load_cell("other.short8k", manifest, here=here)
    assert cell.mix["context_len"] == 8192
    assert [m["name"] for m in cell.per_layer] == ["zero_free"]
    assert load_reader("zero_free", here=here)(None) == 1.5
    (here / "runners" / "chips_4.py").write_text(
        "def run(cell, seed, seconds, trace, t_start):\n    return 4\n")
    assert load_runner(4, here=here)(None, 0, 1, False, 0.0) == 4


def test_cells_find_their_runner_by_chips():
    for w in MANIFEST["workloads"]:
        assert callable(load_runner(w["chips"]))
    with pytest.raises(FileNotFoundError):
        load_runner(8)
