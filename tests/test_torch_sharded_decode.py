"""Sharded decode across ranks and the launch paths of the port, against
the reference:

* ``merge_partials_axis`` and ``flash_decode_ranks`` at N = 2 and 4 (gloo
  CPU ranks joined through the env:// rendezvous, as ``torchrun`` starts
  them): against ``merge_partials`` of every shard's partial in one
  process, and against the arithmetic of the reference's
  ``tests/multidevice/decode_cp_check.py`` (its ``flash_decode`` partials
  in interpret mode, the max and the sums over the shards) at 1e-5, on
  ragged lengths with a row wholly on one shard, a rank that sees
  nothing of a row, and a row with nothing visible;
* ``cache_specs`` against the reference's on the decode caches of four
  families at seven meshes (one of them the reference's two-pod
  2 x 16 x 16);
* ``make_production_mesh``: a world of 4 refused by both forms, and the
  production grids' rank order against the reference's device order
  (16 x 16 on 256 and 2 x 16 x 16 on 512 simulated host devices, in
  subprocesses);
* ``train.main(["--mesh", "2x2", ...])`` under env:// (4 gloo ranks on
  localhost) against the FileStore spawn: the same losses, bit for bit.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_wire_ranks as wr
import repro.configs as jcfgs
import repro.runtime.sharding as jsharding
from repro.compat import make_abstract_mesh
from repro.models import init_cache as jinit_cache
from repro_torch import configs as tcfgs
from repro_torch.core.merge import finalize_partial, merge_partials
from repro_torch.kernels.flash_decode import (decode_reference, flash_decode,
                                              local_lengths)
from repro_torch.launch.mesh import POD_AXES, grid_coords, production_grid
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.launch.train import parse_mesh
from repro_torch.models import init_cache
from repro_torch.runtime.sharding import batch_axes_of, cache_specs
from repro_torch.runtime.zero import named_leaves

jfd = importlib.import_module("repro.kernels.flash_decode")
torch.set_num_threads(1)

TOL = 1e-5
JOIN_TIMEOUT = 240
HERE = os.path.dirname(os.path.abspath(__file__))
S = 128


def _lens_cases(n: int) -> dict:
    """Length mixes of the reference's check at ``n`` shards of S / n,
    plus rows one rank sees nothing of and a row with nothing visible."""
    sl = S // n
    return {"ragged": [S - 1, 17, 63, 0],          # 17: shard 0 alone
            "boundary": [sl - 1, sl, 2 * sl - 1, 5],
            "uniform": [S - 1] * 4,
            "empty_rank": [sl - 1, 3, -1, sl + 1]}   # -1: nothing at all


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4])
def decoded(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"decode{n}")
    spawn_ranks(wr.decode_rank, n,
                args=(n, _free_port(), str(out), _lens_cases(n)),
                timeout=JOIN_TIMEOUT)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    infos = [json.loads((out / f"info{r}.json").read_text())
             for r in range(n)]
    return n, ranks, infos


def _reference_decode(q, k, v, lens, n):
    """decode_cp_check.py's arithmetic: per shard the reference kernel's
    partial (interpret mode) against the clamped local lengths, then the
    max of m and the rescaled sums over the shards, normalized."""
    sl = S // n
    parts = []
    for r in range(n):
        ln = jnp.clip(jnp.asarray(lens, jnp.int32) - r * sl, -1, sl - 1)
        parts.append(jfd.flash_decode(
            jnp.asarray(q), jnp.asarray(k[:, :, r * sl:(r + 1) * sl]),
            jnp.asarray(v[:, :, r * sl:(r + 1) * sl]), ln, block_k=32,
            interpret=True, partial=True))
    m_g = jnp.max(jnp.stack([p[1] for p in parts]), axis=0)
    c = [jnp.exp(p[1] - m_g) for p in parts]
    o_g = sum(p[0] * ci[..., None] for p, ci in zip(parts, c))
    l_g = sum(p[2] * ci for p, ci in zip(parts, c))
    out = jnp.where(l_g[..., None] > 0,
                    o_g / jnp.maximum(l_g[..., None], 1e-30), 0.0)
    return np.asarray(out), np.asarray(m_g), np.asarray(l_g)


def test_sharded_decode_matches_one_process_and_reference(decoded):
    n, ranks, infos = decoded
    q, k, v = wr.decode_inputs()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    sl = S // n
    assert all(i["backend"] == "gloo" for i in infos)
    assert [i["rank"] for i in infos] == list(range(n))
    for name, lens in _lens_cases(n).items():
        ln = torch.tensor(lens, dtype=torch.int32)
        parts = [flash_decode(tq, tk[:, :, r * sl:(r + 1) * sl],
                              tv[:, :, r * sl:(r + 1) * sl],
                              local_lengths(ln, r * sl, sl), partial=True)
                 for r in range(n)]
        o, m, l = merge_partials(parts)
        want_out = finalize_partial((o, m, l), tq.dtype).numpy()
        ref_out, ref_m, ref_l = _reference_decode(q, k, v, lens, n)
        oracle = decode_reference(tq, tk, tv, ln).numpy()
        for r, got in enumerate(ranks):
            tag = f"N={n} {name} rank {r}"
            for x, w in (("o", o), ("m", m), ("l", l)):
                np.testing.assert_allclose(got[f"{name}/{x}"], w.numpy(),
                                           atol=TOL, rtol=TOL,
                                           err_msg=f"{tag} {x}")
            out = got[f"{name}/out"]
            np.testing.assert_allclose(out, want_out, atol=TOL, rtol=TOL,
                                       err_msg=tag)
            np.testing.assert_allclose(out, ref_out, atol=TOL, rtol=TOL,
                                       err_msg=f"{tag} (reference)")
            np.testing.assert_allclose(out, oracle, atol=TOL, rtol=TOL,
                                       err_msg=f"{tag} (dense oracle)")
            np.testing.assert_allclose(got[f"{name}/l"], ref_l, atol=TOL,
                                       rtol=TOL, err_msg=f"{tag} l")
        # where something is visible, the merged max is the reference's
        seen = np.asarray(lens) >= 0
        np.testing.assert_allclose(ranks[0][f"{name}/m"][seen], ref_m[seen],
                                   atol=TOL, rtol=TOL)
        if name == "empty_rank":
            assert not ranks[0][f"{name}/out"][2].any()
    if n == 4:            # the production meshes refuse a world of 4
        for info in infos:
            assert "16x16 needs a world of 256 ranks, got 4" in \
                info["production"]
            assert "2x16x16 needs a world of 512 ranks, got 4" in \
                info["multi_pod"]


PROD_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + \
    sys.argv[2]
sys.path.insert(0, sys.argv[1])
import json
import numpy as np
from repro.launch.mesh import make_production_mesh
mesh = make_production_mesh(multi_pod=sys.argv[2] == "512")
ids = np.vectorize(lambda d: d.id)(mesh.devices)
print("GRID", json.dumps({"axes": list(mesh.axis_names),
                          "ids": ids.tolist()}))
"""


def _reference_grid(devices: int) -> dict:
    """The reference's production mesh on ``devices`` simulated host
    devices (256: one pod; 512: two): its axes and device ids."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", PROD_SCRIPT, os.path.join(HERE, "..", "src"),
         str(devices)], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.split("GRID", 1)[1])


def test_production_grid_matches_reference_device_order():
    ref = _reference_grid(256)
    assert ref["axes"] == ["data", "model"]
    np.testing.assert_array_equal(production_grid().numpy(),
                                  np.asarray(ref["ids"]))
    assert parse_mesh("prod") == tuple(production_grid().shape)


def test_multi_pod_grid_matches_reference_device_order():
    """The two-pod mesh (no longer refused): every rank at the
    coordinate the reference's 2 x 16 x 16 mesh gives its device, the
    coordinates the ranks read (``grid_coords``) those of the grid."""
    ref = _reference_grid(512)
    assert tuple(ref["axes"]) == POD_AXES
    grid = production_grid(multi_pod=True)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(ref["ids"]))
    for rank in (0, 17, 255, 256, 300, 511):
        want = dict(zip(POD_AXES, np.argwhere(np.asarray(ref["ids"])
                                              == rank)[0].tolist()))
        assert grid_coords(grid, POD_AXES, rank) == want


ARCHS = ("starcoder2_3b", "olmoe_1b_7b", "jamba_v0_1_52b", "xlstm_350m")
MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
          {"data": 2, "model": 4}, {"data": 4, "model": 2},
          {"data": 3, "model": 8}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


def _spec(p):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in p)


def _flat(tree) -> dict:
    """{"sub_0/k": leaf} of a reference cache tree."""
    return {"/".join(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    """The port's dense cache (8 rows of 64 positions, full width) has
    the reference's leaves and shapes, and at every mesh the reference's
    specs: the batch over the batch axes where it divides, the largest
    dim that ``model`` divides (S, or a state's feature axis) over
    ``model``."""
    tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
    jtree = jax.eval_shape(lambda: jinit_cache(jc, 8, 64))
    shapes = {p: tuple(x.shape)
              for p, x in named_leaves(init_cache(tc, 8, 64, device="cpu"))}
    assert shapes == {p: tuple(x.shape) for p, x in _flat(jtree).items()}
    for axes in MESHES:
        mesh = make_abstract_mesh(tuple(axes.values()), tuple(axes))
        want = {p: _spec(x.spec)
                for p, x in _flat(jsharding.cache_specs(mesh, jtree)).items()}
        got = cache_specs(axes, shapes)
        for p in shapes:
            w = want[p] + (None,) * (len(shapes[p]) - len(want[p]))
            assert got[p] == w, (arch, axes, p)
        assert batch_axes_of(axes) == jsharding.batch_axes_of(mesh)


def _losses_of(out_dir, world):
    runs = [json.loads((out_dir / f"losses{r}.json").read_text())
            for r in range(world)]
    assert all(r == runs[0] for r in runs), "ranks disagree"
    return runs[0]


def test_train_main_under_env_matches_filestore_spawn(tmp_path):
    """Four processes started with the launcher's variables run
    ``train.main(["--mesh", "2x2", ...])`` themselves (each one rank,
    nothing spawned): every rank's losses equal, bit for bit, those of
    the ranks the CLI's FileStore path starts."""
    argv = ["--smoke", "--device", "cpu", "--seq-len", "256", "--batch",
            "2", "--q-chunk", "64", "--steps", "3", "--mesh", "2x2",
            "--dist-backend", "gloo"]
    env_dir, file_dir = tmp_path / "env", tmp_path / "file"
    env_dir.mkdir()
    file_dir.mkdir()
    spawn_ranks(wr.train_env_rank, 4,
                args=(4, _free_port(), str(env_dir), argv),
                timeout=JOIN_TIMEOUT)
    spawn_ranks(wr.train_file_rank, 4,
                args=(4, str(file_dir / "store"), str(file_dir), argv),
                timeout=JOIN_TIMEOUT)
    env, filestore = _losses_of(env_dir, 4), _losses_of(file_dir, 4)
    assert len(env) == 3 and all(np.isfinite(env))
    assert env == filestore
