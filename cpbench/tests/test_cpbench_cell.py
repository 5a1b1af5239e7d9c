"""A tiny cell runs end to end on the CPU (the port's plain attention
twins, a seconds-long window), and ``correct`` comes out false with the
timed path broken underneath or the control in the port's place.

The tiny cell is ``sc2_3b_e32.train.wlb_llm`` cut to 2 layers of width 64 on
1024-token rows, in float32 so that the port and the reference agree to
rounding; it is judged by the cell's own limits.  The ``gpu`` tests run
the cell itself on the card.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from cpbench.control import control_readings
from cpbench.manifest import ModelSpec, load_cell
from cpbench.run import run_cell
from cpbench.check import judge

CELL = "sc2_3b_e32.train.wlb_llm"


def tiny_cell(name=CELL, dtype="float32"):
    cell = load_cell(name)
    cfg = json.loads((cell_file(name)).read_text())
    cfg.update(hidden_size=64, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=512)
    cfg["train"] = dict(cfg["train"], dtype=dtype)
    spec = ModelSpec.from_file(cell.spec.name, cfg)
    mix = dict(cell.mix, context_len=1024)
    return dataclasses.replace(cell, spec=spec, mix=mix)


def cell_file(name):
    from cpbench.manifest import ROOT, load_manifest
    man = load_manifest()
    w = next(w for w in man["workloads"] if w["name"] == name)
    c = next(c for c in man["configs"] if c["name"] == w["config"])
    return ROOT / c["file"]


def test_the_head_is_tied_as_the_source_states():
    """The configuration ties the head to the embedding table, as
    StarCoder2 does; the port's parameters and the reference's leaves
    are then the same paths and shapes, with no head of its own."""
    from cpbench.port import flatten, import_port, model_config
    from cpbench.manifest import load_reference

    cell = tiny_cell()
    assert cell.spec.tie
    mod = load_reference(cell.spec.reference)
    import_port()
    from repro_torch.models.transformer import init_params

    port = flatten(init_params(model_config(cell.spec, mod.PORT_MODEL),
                               device="cpu"))
    ref = {p: tuple(shape) for p, shape, _ in mod.leaf_specs(cell.spec)}
    assert {p: tuple(x.shape) for p, x in port.items()} == ref
    assert mod.HEAD not in ref


def _run(cell, trace=False, fault=None, seed=2 ** 31 + 17):
    return run_cell(cell, seed, 0.5, trace, device="cpu",
                    t_start=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_end_to_end(trace):
    cell = tiny_cell()
    r = _run(cell, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["plan_cache"]["plans"] == r["attempted"]
    if trace:
        assert {"batch_wait_ms", "plan_ms_per_step"} <= set(r["metrics"])
        assert r["device"]["window_s"] > 0
    else:
        assert {"train_tokens_per_s", "setup_s"} <= set(r["metrics"])


def _unchanged(step_fn):
    """A step that returns its state unchanged."""
    def step(params, opt, batch, i):
        (loss, m), _ = step_fn.loss_and_grads(params, batch)
        z = torch.zeros(())
        return {"loss": loss, "grad_norm": z, "lr": z, "tokens": z,
                "aux": m["aux"]}
    return step


def _half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(params, opt, batch, i):
        lab = batch["labels"].clone()
        lab[:, lab.shape[1] // 2:] = -1
        return step_fn(params, opt, {**batch, "labels": lab}, i)
    return step


def _tokens_altered(step_fn):
    """Every token altered where the feed produced it."""
    def step(params, opt, batch, i):
        tok = batch["tokens"]
        tok = torch.where(tok >= 0, (tok + 1) % 512, tok)
        return step_fn(params, opt, {**batch, "tokens": tok}, i)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _tokens_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(fault):
    r = _run(tiny_cell(), fault=fault)
    assert not r["correct"], r["checks"]


def test_the_control_is_not_correct():
    cell = tiny_cell(dtype="bfloat16")
    read = control_readings(cell, 5, "cpu")
    ok, checks = judge(read["control"], cell.limits["limits"])
    assert not ok, checks
    ok, checks = judge(read["half_batch"], cell.limits["limits"])
    assert not ok, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sc2_3b_e32.train.wlb_llm",
                                  "sc2_3b_e32.train.pile"])
def test_the_cell_with_a_broken_step_is_not_correct_on_the_card(card, name):
    r = run_cell(load_cell(name), 2 ** 31 + 3, 2.0, False, device=card,
                 t_start=time.perf_counter(), fault=_unchanged)
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(card):
    cell = load_cell(CELL)
    read = control_readings(cell, 2 ** 31 + 5, card)
    for name in ("control", "half_batch"):
        ok, checks = judge(read[name], cell.limits["limits"])
        assert not ok, (name, checks)
    assert np.isfinite(read["control"]["loss_gap"])
