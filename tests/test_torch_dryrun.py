"""The port's per-rank dry run against the JAX package's:

* ``SHAPES`` and ``cell_skip_reason`` equal the reference's, for every
  arch and shape;
* ``model_flops`` and ``roofline_terms`` equal the reference's for one
  ``hw`` dict, over every arch x shape x {256, 512} devices;
* the recording communicator: the flashcp island at N = 4 (plain
  attention, chunked and monolithic) counts the same bytes by kind on
  ``meta`` tensors as a real gloo ``CPComm`` on the CPU, forward and
  backward, and its forward the island's analytic budget
  (``analysis.wire_audit.island_budget``); in the same spawn, the dry
  run's decode on a cache split over the ranks against the whole cache;
* the cost analysis: a matmul's FLOPs and bytes, the peak of live
  storages, a pointwise op's fast ``meta`` result against the op's own;
* the dry-run record of smoke cells (train, prefill, decode) on small
  meshes, one and two pods: the reference's schema
  (cf. ``tests/test_system.py::test_dryrun_cell_records_schema``), the
  ZeRO-3 state bytes those of the layout's shard shapes, no kernel
  reached; and ``main`` writing its results file.
"""

import dataclasses
import importlib
import json
import math
import os

import jax
import pytest
import torch

import _torch_dryrun_ranks as dranks
import repro.configs as jcfgs
import repro.launch.roofline as jroof
import repro.launch.steps as jsteps
from _torch_cp_ranks import B, HKV, D
from repro_torch import configs as tcfgs
from repro_torch.analysis.wire_audit import audit_wire, island_budget
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.runtime.zero import Zero3

JOIN_TIMEOUT = 240
HW = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9}


def _reference_dryrun():
    """The reference's dry-run module, imported without keeping the
    512-device ``XLA_FLAGS`` it sets for its own process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_shapes_and_skips_match_reference():
    jdry = _reference_dryrun()
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    assert sorted(tcfgs.ARCHS) == sorted(jcfgs.ARCHS)
    for arch in tcfgs.ARCHS:
        for name in tcfgs.SHAPES:
            assert dryrun.cell_skip_reason(
                tcfgs.get_config(arch), tcfgs.SHAPES[name]) == \
                jdry.cell_skip_reason(jcfgs.get_config(arch),
                                      jcfgs.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("cp", [1, 16])
def test_input_specs_match_reference(cp):
    """``default_buf_len``, ``train_input_specs`` (the plain attention's:
    no visit tables) and ``decode_input_specs``: the reference's shapes
    and dtypes, every arch and shape."""
    for arch in tcfgs.ARCHS:
        tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
        for name, shape in tcfgs.SHAPES.items():
            js = jcfgs.SHAPES[name]
            assert dryrun.default_buf_len(shape.seq_len, cp) == \
                jsteps.default_buf_len(js.seq_len, cp)
            got = dryrun.train_input_specs(tc, shape, cp)
            want = jsteps.train_input_specs(jc, js, cp)
            assert {k: (s, str(d).split(".")[-1]) for k, (s, d)
                    in got.items()} == {k: (v.shape, str(v.dtype)) for k, v
                                        in want.items()}, (arch, name)
        if cp == 1:
            shape = tcfgs.ShapeConfig("d", 64, 4, "decode")
            got = dryrun.decode_input_specs(tc, shape)
            want = jsteps.decode_input_specs(
                jc, jcfgs.ShapeConfig("d", 64, 4, "decode"))
            assert {k: s for k, (s, _) in got["batch"].items()} == \
                {k: v.shape for k, v in want["batch"].items()}
            flat = jax.tree_util.tree_flatten_with_path(want["cache"])[0]
            assert {p: s for p, (s, _) in got["cache"].items()} == \
                {"/".join(str(k.key) for k in path): x.shape
                 for path, x in flat}, arch


@pytest.mark.parametrize("devices", [256, 512])
def test_model_flops_and_roofline_match_reference(devices):
    for arch in tcfgs.ARCHS:
        for name in tcfgs.SHAPES:
            got = model_flops(tcfgs.get_config(arch), tcfgs.SHAPES[name],
                              num_devices=devices)
            want = jroof.model_flops(jcfgs.get_config(arch),
                                     jcfgs.SHAPES[name], num_devices=devices)
            assert got == want, (arch, name)
            args = (got, got / 3.0, got / 7.0)
            assert roofline_terms(*args, hw=HW) == \
                jroof.roofline_terms(*args, hw=HW)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recording")
    world = 4
    spawn_ranks(dranks.recording_rank, world,
                args=(world, str(tmp / "store"), str(tmp)),
                timeout=JOIN_TIMEOUT)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("overlap", dranks.OVERLAPS)
def test_recording_comm_counts_what_gloo_sends(recorded, overlap):
    for r, res in enumerate(recorded):
        real, rec = res[overlap]["real"], res[overlap]["recorded"]
        assert rec["forward"] == real["forward"], (r, overlap)
        assert rec["all"] == real["all"], (r, overlap)
        assert real["forward"]["permute" if overlap == "chunked"
                               else "all_gather"] > 0
        budget = island_budget("flashcp", overlap,
                               buf_len=real["buf_len"], num_workers=4,
                               kv_heads=HKV, head_dim=D, dtype_bytes=4,
                               batch=B)
        assert not audit_wire(rec["forward"], budget,
                              context=f"rank{r}/{overlap}")
        for kind, cap in budget.allowed.items():
            assert abs(rec["forward"][kind] - cap) <= 0.01 * cap


def test_split_cache_decode_matches_the_whole_cache(recorded):
    """The dry run's decode (``decode_step(cache_comm=...)``: each rank
    its S slice of the attention caches, partials merged over 4 gloo
    ranks) gives the whole cache's logits (f32, smoke model)."""
    for res in recorded:
        assert res["split_decode_err"] < 1e-5


def test_cost_mode_counts_flops_bytes_and_peak():
    x = torch.empty((64, 32), device="meta")
    w = torch.empty((32, 16), device="meta")
    mode = CostMode()
    mode.track(x, w)
    base = mode.live_bytes
    assert base == (64 * 32 + 32 * 16) * 4
    with mode:
        y = x @ w                       # 64 x 16
        z = torch.relu(y)
        del y
        s = z.sum()
    assert mode.flops == 2 * 64 * 32 * 16
    assert mode.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 \
        + 2 * 64 * 16 * 4 + (64 * 16 + 1) * 4
    # x, w, y and z were alive together
    assert mode.peak_bytes == base + 2 * 64 * 16 * 4
    assert mode.live_bytes == base + 64 * 16 * 4 + 4     # z and s
    del z, s


def test_pointwise_meta_results_match_the_ops():
    a = torch.empty((4, 1, 8), dtype=torch.bfloat16, device="meta")
    b = torch.empty((3, 1), dtype=torch.float32, device="meta")
    i = torch.empty((4, 3, 8), dtype=torch.int32, device="meta")
    cases = [lambda: a * b, lambda: a + 1.5, lambda: i * 2,
             lambda: i / 2, lambda: torch.where(i > 0, a, b),
             lambda: i >= 3, lambda: torch.exp(i),
             lambda: a * torch.tensor(2.0)]
    with CostMode():
        fast = [f() for f in cases]
    for f, got in zip(cases, fast):
        want = f()
        assert got.shape == want.shape and got.dtype == want.dtype


def test_kernels_are_forbidden_in_the_dry_run():
    with _build.forbid_kernels("a test"):
        with pytest.raises(RuntimeError, match="forbid_kernels"):
            _build.doc_attention_lib()
        with pytest.raises(RuntimeError, match="forbid_kernels"):
            _build.flash_decode_lib()


SCHEMA = {"arch", "shape", "mesh", "memory", "cost", "collectives",
          "roofline", "model_flops_per_device", "useful_flops_frac", "fits"}


def _state_bytes(cfg, axes) -> int:
    """A rank's ZeRO-3 state from the layout's shard shapes: the
    parameters, f32 mu and nu (and an f32 master below f32), and the
    step count."""
    specs = dryrun._param_specs(cfg)
    zero = Zero3.from_layout(axes, {a: 0 for a in axes},
                             {p: s for p, (s, _) in specs.items()},
                             lambda a: None)
    esize = {p: torch.empty((), dtype=d).element_size()
             for p, (_, d) in specs.items()}
    f32 = 12 if min(esize.values()) < 4 else 8
    return sum(math.prod(s) * (esize[p] + f32)
               for p, s in zero.shard_shapes().items()) + 4


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2},
                                  {"pod": 2, "data": 1, "model": 2},
                                  {"pod": 2, "data": 2, "model": 1}],
                         ids=["2x2", "2x1x2", "2x2x1"])
@pytest.mark.parametrize("arch", ["starcoder2_3b", "olmoe_1b_7b"])
def test_smoke_train_cell_record(arch, axes):
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    shape = tcfgs.ShapeConfig("smoke", 256, 4, "train")
    launches = [k.launches for k in dryrun.KERNELS]
    rec = dryrun.run_cell(arch, "smoke", axes=axes, cfg=cfg, shape=shape)
    assert rec["status"] == "ok" and SCHEMA <= set(rec)
    assert [k.launches for k in dryrun.KERNELS] == launches
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["mesh"] == "x".join(map(str, axes.values()))
    assert rec["memory"]["state_bytes"] == _state_bytes(cfg, axes)
    mem = rec["memory"]
    assert mem["peak_bytes_kernel_adjusted"] <= mem["peak_bytes_per_device"]
    assert mem["argument_bytes"] <= mem["peak_bytes_kernel_adjusted"]
    assert rec["cost"]["flops_per_device"] > 0
    # ZeRO-3 moves the parameters on every mesh axis of size > 1
    assert rec["collectives"]["by_kind"]["all_gather"] > 0
    assert rec["collectives"]["by_kind"]["reduce_scatter"] > 0


@pytest.mark.parametrize("axes", [{"data": 1, "model": 1},
                                  {"pod": 2, "data": 1, "model": 2}],
                         ids=["1x1", "2x1x2"])
def test_kernel_adjustment_leaves_out_scores_only(axes):
    """At d_ff = heads x q_chunk an MLP activation has the byte size of a
    chunk's scores; the kernel-adjusted bytes leave out the attention's
    score and mask tensors only, so the bytes left out do not depend on
    d_ff."""
    base = tcfgs.reduce_for_smoke(tcfgs.get_config("starcoder2_3b"))
    shape = tcfgs.ShapeConfig("smoke", 256, 4, "train")
    q_chunk = 32
    left_out = []
    for d_ff in (base.num_heads * q_chunk, base.num_heads * q_chunk + 8):
        cfg = dataclasses.replace(base, d_ff=d_ff)
        rec = dryrun.run_cell("starcoder2_3b", "smoke", axes=axes, cfg=cfg,
                              shape=shape, q_chunk=q_chunk)
        cost = rec["cost"]
        left_out.append(cost["bytes_per_device"]
                        - cost["bytes_kernel_adjusted"])
    assert left_out[0] == left_out[1] > 0


@pytest.mark.parametrize("kind,arch", [("prefill", "starcoder2_3b"),
                                       ("decode", "starcoder2_3b"),
                                       ("decode", "jamba_v0_1_52b"),
                                       ("prefill", "musicgen_medium")])
def test_smoke_serving_cells_trace(kind, arch):
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    shape = tcfgs.ShapeConfig("smoke", 256, 4, kind)
    rec = dryrun.run_cell(arch, "smoke", axes={"pod": 2, "data": 1,
                                              "model": 2},
                          cfg=cfg, shape=shape)
    assert rec["status"] == "ok" and SCHEMA <= set(rec)
    assert rec["collectives"]["by_kind"]["all_gather"] > 0
    if kind == "decode":
        # the split cache's partials merge over ``model``
        assert rec["collectives"]["by_kind"]["all_reduce"] > 0


def test_main_writes_results(tmp_path):
    out = tmp_path / "res.json"
    assert dryrun.main(["--arch", "xlstm_350m", "--shape", "decode_32k",
                        "--results", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    assert all(r["status"] == "ok" and r["fits"] for r in recs)
    assert dryrun.main(["--arch", "starcoder2_3b", "--shape", "long_500k",
                        "--multi-pod", "single", "--results",
                        str(out)]) == 0
    skip = [r for r in json.loads(out.read_text())
            if r["shape"] == "long_500k"]
    assert skip[0]["status"] == "skip"
