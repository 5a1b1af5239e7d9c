"""The port's checkpoint manager: the reference's checkpoint cases
(tests/test_checkpoint.py) restated against it, bf16 round trips,
interoperation with the reference's manager both ways, and
reshard-on-restore through the ZeRO-3 layout."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.runtime import sharding


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((8, 4))
                                             .astype(np.float32)),
                       "nested": {"b": torch.arange(5, dtype=torch.int32)}},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    g, w = _flatten(got), _flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("mode", ["blocking", "async", "overwrite"])
def test_save_restore_roundtrip(tmp_path, mode):
    """A save restores exactly: blocking, asynchronous (after wait), and
    a second save of the same step replacing the first."""
    mgr = CheckpointManager(str(tmp_path))
    if mode == "overwrite":
        mgr.save(2, _state(0))
    mgr.save(2, _state(1), blocking=mode != "async")
    mgr.wait()
    assert mgr.latest_step() == 2
    step, restored, manifest = mgr.restore()
    assert step == 2 and manifest["step"] == 2
    _assert_tree_equal(restored, _state(1))


def test_restore_maps_each_leaf_as_it_is_read(tmp_path):
    """``restore(leaf=)`` hands every leaf whole to ``leaf`` once, under
    its flattened key, and the tree keeps only what ``leaf`` returns (a
    rank keeps its shards and never the whole tree); ``manifest`` reads
    the same manifest without the arrays."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, _state(2))
    want, seen = _flatten(_state(2)), []

    def leaf(key, x):
        seen.append(key)
        torch.testing.assert_close(x, want[key], rtol=0, atol=0, msg=key)
        return x[:1] if x.dim() else x

    _, restored, manifest = mgr.restore(leaf=leaf)
    assert sorted(seen) == sorted(want)
    _assert_tree_equal(restored, {
        "params": {"w": want["params/w"][:1],
                   "nested": {"b": want["params/nested/b"][:1]}},
        "opt": _state(2)["opt"]})
    assert mgr.manifest(4) == manifest


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        mgr.save(s, _state(s))
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]          # keep=2 garbage-collected


def test_no_partial_checkpoint_visible(tmp_path):
    """Staging directories are never listed as checkpoints."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_000000004.123.9.tmp"))
    assert mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def _fail_writes(monkeypatch):
    def boom(self, step, host, extra, tmp):
        os.makedirs(tmp, exist_ok=True)           # stage partially...
        raise OSError("disk full")                # ...then die pre-commit

    monkeypatch.setattr(CheckpointManager, "_write", boom)


@pytest.mark.parametrize("surfaces_at", ["wait", "next_save"])
def test_async_save_error_reraised_not_silent(tmp_path, monkeypatch,
                                              surfaces_at):
    """A failed background save surfaces once, on the next ``wait()`` or
    ``save()``, and the manager then saves again."""
    mgr = CheckpointManager(str(tmp_path))
    _fail_writes(monkeypatch)
    mgr.save(1, _state(), blocking=False)
    if surfaces_at == "wait":
        with pytest.raises(RuntimeError, match="checkpoint save failed"):
            mgr.wait()
        mgr.wait()                                # consumed once
        monkeypatch.undo()
    else:
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="checkpoint save failed"):
            mgr.save(2, _state())
    mgr.save(2, _state())
    assert mgr.latest_step() == 2
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]


def test_crash_mid_save_keeps_previous_checkpoint(tmp_path, monkeypatch):
    """A save that dies before its commit leaves the previous checkpoint
    latest and restorable, and no staging behind."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    _fail_writes(monkeypatch)
    with pytest.raises(RuntimeError):
        mgr.save(2, _state(2))
    assert mgr.latest_step() == 1
    assert mgr.all_steps() == [1]
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]
    _, restored, _ = mgr.restore()
    _assert_tree_equal(restored, _state(1))
    monkeypatch.undo()
    mgr.save(2, _state(2))
    assert mgr.latest_step() == 2


def test_gc_never_collects_just_written_step(tmp_path):
    """Stale higher steps of an earlier run in the same directory do not
    make retention delete the step a new run just wrote."""
    stale = CheckpointManager(str(tmp_path), keep=2)
    for s in (7, 8):
        stale.save(s, _state(s))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, _state(3))
    assert mgr.latest_step() == 3                 # LATEST written last wins
    _, restored, _ = mgr.restore()
    _assert_tree_equal(restored, _state(3))


def test_dangling_latest_pointer_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    shutil.rmtree(os.path.join(str(tmp_path), "step_000000002"))
    assert mgr.latest_step() == 1                 # LATEST=2 is dangling
    step, _, _ = mgr.restore()
    assert step == 1


def test_stale_tmp_from_dead_process_swept(tmp_path):
    """Staging whose pid is dead (or unreadable) is swept at
    construction; this process's own is kept."""
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()                                   # reaped: pid is dead
    dead = os.path.join(str(tmp_path), f"step_000000001.{proc.pid}.7.tmp")
    mine = os.path.join(str(tmp_path),
                        f"step_000000002.{os.getpid()}.7.tmp")
    junk = os.path.join(str(tmp_path), "step_000000003.zz.tmp")
    for d in (dead, mine, junk):
        os.makedirs(d)
    CheckpointManager(str(tmp_path))
    assert not os.path.exists(dead)
    assert os.path.exists(mine)
    assert not os.path.exists(junk)


def test_bf16_roundtrip_is_exact_and_stored_as_16_bit_patterns(tmp_path):
    """numpy has no bfloat16: the leaf is stored as its bits (``|V2``, as
    the reference's arrays land in an npz) and the manifest's dtype
    restores it, every bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32)
                         * 1e3).to(torch.bfloat16)
    x[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": x}})
    _, restored, manifest = mgr.restore()
    got = restored["params"]["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))
    assert manifest["arrays"]["params/w"] == {"shape": [6, 10],
                                              "dtype": "bfloat16"}
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as f:
        assert f["params/w"].dtype == np.dtype("V2")


def _smoke_state():
    """The reference's smoke starcoder2_3b parameters and a one-step
    optimizer state, as numpy (f32 and an int32 count)."""
    from repro.configs import get_config, reduce_for_smoke
    from repro.models import init_params
    from repro.optim import adamw_init

    cfg = reduce_for_smoke(get_config("starcoder2_3b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    opt = adamw_init(params)
    opt["mu"] = jax.tree.map(lambda p: p * 0.5, params)
    opt["count"] = jnp.asarray(1, jnp.int32)
    return jax.tree.map(np.asarray, {"params": params, "opt": opt})


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    state = _smoke_state()
    JManager(str(tmp_path)).save(4, state)
    step, restored, _ = CheckpointManager(str(tmp_path)).restore()
    assert step == 4
    want, got = _flatten(state), _flatten(restored)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    state = _smoke_state()
    tstate = _as_torch(state)
    CheckpointManager(str(tmp_path)).save(6, tstate)
    jm = JManager(str(tmp_path))
    assert jm.latest_step() == 6
    step, restored, manifest = jm.restore()
    assert step == 6 and manifest["step"] == 6
    want, got = _flatten(state), _flatten(restored)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("target", [(1, 4), (1, 1)], ids=["1x4", "1x1"])
def test_reshard_on_restore(tmp_path, target):
    """Shards of a 2x2 mesh (as ``Zero3`` gathers them whole for rank 0
    to write) restore into the shards of another mesh: each rank's piece
    of the whole leaves under its own layout."""
    state = _as_torch(_smoke_state())
    whole = _flatten(state)
    shapes = {k: tuple(v.shape) for k, v in whole.items()}

    def pieces(mesh):
        axes = dict(zip(("data", "model"), mesh))
        specs = sharding.param_specs(axes, shapes)
        return [{k: sharding.take_shard(v, specs[k], axes,
                                        {"data": r // mesh[1],
                                         "model": r % mesh[1]})
                 for k, v in whole.items()}
                for r in range(mesh[0] * mesh[1])], specs

    src, specs = pieces((2, 2))
    # assemble the 2x2 shards whole, as the gathers do
    axes = {"data": 2, "model": 2}
    rebuilt = {}
    for k, shape in shapes.items():
        out = torch.empty(shape, dtype=whole[k].dtype)
        for r, piece in enumerate(src):
            sharding.take_shard(out, specs[k], axes,
                                {"data": r // 2, "model": r % 2})[...] = \
                piece[k]
        rebuilt[k] = out
    from repro_torch.checkpoint.manager import _unflatten
    CheckpointManager(str(tmp_path)).save(2, _unflatten(rebuilt))
    _, restored, _ = CheckpointManager(str(tmp_path)).restore()
    restored = _flatten(restored)
    want, tspecs = pieces(target)
    axes_t = dict(zip(("data", "model"), target))
    for r, piece in enumerate(want):
        coords = {"data": r // target[1], "model": r % target[1]}
        for k, w in piece.items():
            got = sharding.take_shard(restored[k], tspecs[k], axes_t, coords)
            assert torch.equal(got, w), (r, k)
    assert any(len(sharding.spec_axes(s)) for s in tspecs.values()) \
        == (target != (1, 1))
