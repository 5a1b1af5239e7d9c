"""The port's four examples (``examples/*_torch.py``) on the CPU
(``--device cpu``), against the reference's examples where they print
the same thing:

* ``plan_explorer_torch`` prints what ``examples/plan_explorer.py``
  prints, character for character;
* ``quickstart_torch`` prints the reference's plan report, and its tiny
  training (the kernels' twins here) lowers the loss;
* ``serve_decode_torch`` completes every request with ``--gen`` tokens
  on the paged layout;
* ``train_lm_torch`` keeps the reference's ``LM_100M`` field for field;
  cut to 2 layers of d 128 over 512 tokens, its ``main`` trains, writes
  its checkpoints, and a second call with more steps resumes from the
  last one with the losses an in-process continuation gives;
* with no card, every example refuses to start unless given
  ``--device cpu``.
"""

import dataclasses
import importlib.util
import math
import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "plan_explorer", "serve_decode", "train_lm")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plan_explorer_prints_what_the_reference_prints(capsys,
                                                         monkeypatch):
    flags = ["--context", "8192", "--cp", "4", "--strategy", "all"]
    monkeypatch.setattr(sys, "argv", ["plan_explorer.py", *flags])
    runpy.run_path(str(ROOT / "examples" / "plan_explorer.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    _load("plan_explorer_torch").main([*flags, "--device", "cpu"])
    ours = capsys.readouterr().out
    assert "--- flashcp" in ours and "--- llama3" in ours
    assert ours == ref


def test_quickstart_plan_report_is_the_references(capsys):
    _load("quickstart").show_plans()
    ref = capsys.readouterr().out
    _load("quickstart_torch").show_plans()
    ours = capsys.readouterr().out
    assert "FlashCP (Algorithm 1):" in ours
    assert ours == ref


def test_quickstart_tiny_training_lowers_the_loss(tmp_path, monkeypatch,
                                                  capsys):
    mod = _load("quickstart_torch")
    monkeypatch.setattr(mod, "CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(mod, "TINY_STEPS", 4)
    out = mod.main(["--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 4 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0]
    assert "Tiny end-to-end training (reduced starcoder2_3b, cpu)" in \
        capsys.readouterr().out


def test_serve_decode_completes_every_request():
    out = _load("serve_decode_torch").main([
        "--requests", "3", "--prompt-len", "32", "--gen", "5",
        "--device", "cpu"])
    assert out["kv_layout"] == "paged"
    assert sorted(out["results"]) == [0, 1, 2]
    assert all(r["status"] == "ok" for r in out["results"].values())
    assert [len(out["tokens"][r]) for r in range(3)] == [5, 5, 5]


def test_train_lm_config_is_the_references():
    ours, ref = _load("train_lm_torch").LM_100M, _load("train_lm").LM_100M
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()


def test_train_lm_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    import repro_torch.configs as configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step

    mod = _load("train_lm_torch")
    small = dataclasses.replace(mod.LM_100M, num_layers=2, d_model=128,
                                num_heads=2, num_kv_heads=2, d_ff=512,
                                vocab_size=512)
    monkeypatch.setattr(mod, "LM_100M", small)
    monkeypatch.setattr(mod, "CKPT_DIR", str(tmp_path))
    monkeypatch.setitem(configs.ARCHS, small.name, small)
    out = mod.main(["--steps", "4", "--device", "cpu"])
    assert len(out["losses"]) == 4
    assert all(map(math.isfinite, out["losses"]))
    assert out["config"] == small
    assert (tmp_path / "LATEST").read_text().strip() == "step_000000004"

    # the same two steps in process, on the schedule of a 6-step run
    run = dataclasses.replace(out["run"], total_steps=6, warmup_steps=1)
    step_fn = build_train_step(small, run, q_chunk=128, device="cpu")
    params, opt = out["params"], out["opt_state"]
    cont = [float(step_fn(params, opt, batch_to_device(
        make_batch(out["pipeline"], s), torch.device("cpu")), s)["loss"])
        for s in (4, 5)]
    resumed = mod.main(["--steps", "6", "--device", "cpu"])
    assert resumed["losses"] == cont


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_to_start_without_a_card(name):
    """Run on the card unless asked for the CPU: with no card and no
    ``--device``, each example raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(f"{name}_torch").main([])
