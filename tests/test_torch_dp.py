"""The distributed training loop of the port against the JAX package: the
train step on meshes with a data axis (ZeRO-3), the Prefetcher, and the
loop end to end (``main`` over gloo ranks, checkpoints, resume on
another mesh, and the reference's own ``train()`` resuming a checkpoint
the port wrote)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.data.pipeline import PipelineConfig, Prefetcher, make_batch
from repro_torch.launch.train import main
from test_torch_train import check_mesh_step

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ["--smoke", "--device", "cpu", "--seq-len", "256", "--batch", "2",
         "--q-chunk", "64"]


@pytest.mark.parametrize("mesh,cases", [
    ((2, 1), [("plain", "none"), ("flash", "none")]),
    ((2, 2), [("plain", "none"), ("flash", "none"), ("plain", "int8")]),
], ids=["2x1", "2x2"])
def test_dp_train_step_matches_jax(mesh, cases, tmp_path):
    """The step with a data axis: each rank its row of step 0's batch (and
    at 2x2 its CP token slice), ZeRO-3 over both axes, against the JAX
    step on the whole batch, at the bounds of
    test_cp_train_step_matches_jax; at 2x2 also with int8 gradient
    compression (per-leaf scales over every rank's shards)."""
    check_mesh_step(mesh, tmp_path, cases)


@pytest.mark.parametrize("mesh,rows", [((2, 1, 2), 2), ((2, 2, 1), 4)],
                         ids=["2x1x2", "2x2x1"])
def test_pod_train_step_matches_jax(mesh, rows, tmp_path):
    """The step on the two-pod layout, a (pod, data, model) mesh of 4 gloo
    ranks: rows over ``pod`` (and ``data``), tokens over ``model``, ZeRO-3
    over all three axes; every rank's shards exact and step 0 against
    the JAX step on the whole batch, at the bounds of
    test_dp_train_step_matches_jax."""
    check_mesh_step(mesh, tmp_path, [("plain", "none"), ("flash", "none")],
                    rows=rows)


def test_prefetcher_yields_make_batch_from_start_step_and_closes():
    cfg = PipelineConfig(context_len=256, batch_per_host=2, cp_size=2,
                         vocab_size=512, align=16, emit_tables=True,
                         table_block_q=16, table_block_k=16)
    pf = Prefetcher(cfg, start_step=3, prefetch=2)
    try:
        for step in (3, 4, 5):
            got, want = next(pf), make_batch(cfg, step)
            assert sorted(got) == sorted(want)
            for k in want:
                if k == "stats":
                    assert got[k]["comm_tokens"] == want[k]["comm_tokens"]
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    bad = Prefetcher(PipelineConfig(strategy="no_such_planner"))
    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        next(bad)
    bad.close()
    assert not bad._thread.is_alive()


def _losses(out: str) -> list[float]:
    return [float(line.split()[4]) for line in out.splitlines()
            if line.startswith("[train] step")]


def test_train_cli_data_axis_matches_one_rank(capfd, tmp_path):
    """``--mesh 2x2`` (4 gloo ranks, ZeRO-3, asynchronous checkpoints every
    2 steps) logs the losses of ``--mesh 1x1`` on the same seed; its
    step-3 checkpoint, written whole by rank 0 from the shards, resumes
    on one rank to the same step-3 loss."""
    argv = SMOKE + ["--steps", "4"]
    main(argv)
    one = _losses(capfd.readouterr().out)
    ckpt = tmp_path / "ckpt"
    main(argv + ["--mesh", "2x2", "--dist-backend", "gloo",
                 "--checkpoint-dir", str(ckpt), "--ckpt-every", "2",
                 "--prefetch"])
    four = _losses(capfd.readouterr().out)
    assert len(one) == 4
    np.testing.assert_allclose(four, one, rtol=1e-4)
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_000000003",
                                        "step_000000004"]
    shutil.rmtree(ckpt / "step_000000004")          # LATEST now dangles
    main(argv + ["--checkpoint-dir", str(ckpt), "--resume"])
    out = capfd.readouterr().out
    assert "[train] resumed from step 3" in out
    np.testing.assert_allclose(_losses(out), four[3:], rtol=1e-4)


def test_train_cli_rows_that_do_not_divide_match_one_rank(capfd):
    """One row on a 2x1 mesh: both data ranks take it (the reference
    replicates rows that do not divide), and the world's label count
    weighs each copy 1/2, so the losses are one rank's."""
    argv = SMOKE + ["--batch", "1", "--steps", "2"]
    main(argv)
    one = _losses(capfd.readouterr().out)
    main(argv + ["--mesh", "2x1", "--dist-backend", "gloo"])
    two = _losses(capfd.readouterr().out)
    assert len(one) == 2
    np.testing.assert_allclose(two, one, rtol=1e-5)


def test_train_resume_matches_uninterrupted(capfd, tmp_path):
    """4 steps with ``--ckpt-every 2``; the same stopped after 2 steps
    (its final save) and ``--resume``d: steps 2-3 agree to 1e-6."""
    argv = SMOKE + ["--ckpt-every", "2"]
    main(argv + ["--steps", "4", "--checkpoint-dir", str(tmp_path / "a")])
    whole = _losses(capfd.readouterr().out)
    main(argv + ["--steps", "2", "--checkpoint-dir", str(tmp_path / "b")])
    first = _losses(capfd.readouterr().out)
    main(argv + ["--steps", "4", "--checkpoint-dir", str(tmp_path / "b"),
                 "--resume", "--prefetch"])
    resumed = _losses(capfd.readouterr().out)
    assert first == whole[:2] and len(resumed) == 2
    np.testing.assert_allclose(resumed, whole[2:], rtol=1e-6)
    with pytest.raises(ValueError, match="need --checkpoint-dir"):
        main(SMOKE + ["--resume"])


REFERENCE_TRAIN = """
import json, sys, types
from repro.launch.train import train
args = types.SimpleNamespace(
    arch="starcoder2_3b", smoke=True, mesh="2x2", strategy="flashcp",
    attention_impl="xla", dataset="wlb_llm", seq_len=256, batch=2, steps=3,
    lr=3e-4, q_chunk=64, grad_compression="none",
    checkpoint_dir=sys.argv[1], ckpt_every=0, log_every=1, resume=True,
    prefetch=False, no_remat=False)
print("LOSSES", json.dumps(train(args)["losses"]))
"""


def test_reference_train_resumes_a_port_checkpoint(capfd, tmp_path):
    """The slice against the reference as a whole: the port writes a
    step-0 checkpoint; the reference's ``train()`` at ``--mesh 2x2`` (4
    simulated host devices) and the port's ``--mesh 2x2`` (4 gloo ranks)
    each resume it and train 3 steps: the same losses to 1e-4 (mesh,
    layout, loop, data and checkpoint format)."""
    main(SMOKE + ["--attention-impl", "plain", "--steps", "0",
                  "--checkpoint-dir", str(tmp_path / "port")])
    capfd.readouterr()
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE_TRAIN,
                           str(tmp_path / "ref")], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "[train] resumed from step 0" in proc.stdout
    ref = json.loads(proc.stdout.split("LOSSES", 1)[1])
    main(SMOKE + ["--attention-impl", "plain", "--steps", "3",
                  "--mesh", "2x2", "--dist-backend", "gloo",
                  "--checkpoint-dir", str(tmp_path / "port"), "--resume"])
    out = capfd.readouterr().out
    assert "[train] resumed from step 0" in out
    assert len(ref) == 3
    np.testing.assert_allclose(_losses(out), ref, rtol=1e-4)
