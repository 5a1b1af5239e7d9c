"""The port's int8 KV wire (``RunConfig.kv_comm_dtype="int8"``) against
the reference's (``repro.core.cp_attention._quantized_ppermute`` and
``_quantized_gather``), on the CP islands of ``tests/test_torch_cp.py``
(C 256, B 2, Hq 4, Hkv 2, D 8, documents [70, 23, 100, 40, 23]).

One spawn of gloo CPU ranks per CP size (2 and 4) runs every island case
on the native wire, on the int8 wire, and, for the all-gather islands,
on the native wire fed K/V already quantized and dequantized.  Held:

* the int8 islands against the reference's own int8 islands (XLA, four
  simulated host devices, one subprocess) at 1e-4, gradients included
  (the quantized values are the same f32 arithmetic on both sides);
* int8 against the native wire at the reference's int8 bounds (output
  3e-2, gradients 5e-2, relative to the largest entry;
  ``tests/multidevice/cp_check.py``);
* the straight-through backward: an all-gather island's int8 output and
  gradients equal the native wire's at the dequantized K/V (1e-5);
* the K/V bytes each rank hands to its ``CPComm``: on the int8 wire the
  forward sends D int8 values and one f32 scale per row, (D + 4) / (4 D)
  of the f32 wire, and the backward the same full-precision bytes;
* the wire audit (``repro_torch.analysis.wire_audit``) on the native
  islands' forward bytes by collective kind: no WIRE finding, each kind
  within 1% of ``kv_exchange_budget``; a flashcp island given an Eq.-5
  buffer twice as wide trips WIRE102, and a budget without the kind the
  island used trips WIRE101.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_ranks as cp
import _torch_wire_ranks as wr
from repro_torch.analysis.wire_audit import audit_wire, island_budget
from repro_torch.core.comm import dequantize_int8, quantize_int8
from repro_torch.core.cp_attention import resolve_overlap
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.planner import get_planner

REF_TOL = 1e-4
WIRE_TOL = {"o": 3e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
ST_TOL = 1e-5
JOIN_TIMEOUT = 240
# (planner, overlap, impl, grid): every island that moves K/V by hop or
# all-gather, on the plain path, and the chunked flashcp island and the
# llama3 all-gather on the flash kernels' twins
ISLANDS = [("flashcp", "chunked", "plain", "rect"),
           ("flashcp", "none", "plain", "rect"),
           ("llama3", "chunked", "plain", "rect"),
           ("llama3", "none", "plain", "rect"),
           ("flashcp", "chunked", "flash", "flat"),
           ("llama3", "none", "flash", "flat")]
# islands whose K/V all reach attention through the gather (no local raw
# copy), so the native wire at the dequantized K/V is the int8 wire
GATHERED = [c for c in ISLANDS if c[0] == "llama3" and c[1] == "none"]
# flashcp islands run again with the Eq.-5 buffer twice as wide
WIDENED = [c for c in ISLANDS if c[0] == "flashcp" and c[2] == "plain"]
CASES = [(*c, w) for c in ISLANDS for w in ("native", "int8")] + \
    [(*c, "native@dq") for c in GATHERED] + \
    [(*c, "native@2buf") for c in WIDENED]
NAMES = ("o", "dq", "dk", "dv")
HERE = os.path.dirname(os.path.abspath(__file__))


def _key(case):
    return "/".join(case[:4])


@pytest.fixture(scope="module", params=[2, 4])
def wires(request, tmp_path_factory):
    """(cp, {case: plan-order [o, dq, dk, dv]}, {case: [bytes by rank]})."""
    n = request.param
    out = tmp_path_factory.mktemp(f"wire{n}")
    spawn_ranks(wr.wire_rank, n, args=(n, str(out / "store"), str(out),
                                       CASES), timeout=JOIN_TIMEOUT)
    per_rank = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    nbytes = [json.loads((out / f"bytes{r}.json").read_text())
              for r in range(n)]
    res = {case: [np.concatenate([p[f"{wr.case_key(*case)}/{x}"]
                                  for p in per_rank], axis=2)
                  for x in NAMES] for case in CASES}
    return n, res, {case: [b[wr.case_key(*case)] for b in nbytes]
                    for case in CASES}


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, set_mesh
from repro.core.cp_attention import make_cp_context
from repro.planner import encode_plan_batch, get_planner

inp = np.load(sys.argv[2])
doc_lens = inp["doc_lens"]
out = {}
for case in sys.argv[4:]:
    n, plan_name, overlap = case.split(",")
    n = int(n)
    q, k, v = (inp[f"{case}/{x}"] for x in ("q", "k", "v"))
    plans = [get_planner(plan_name)(doc_lens, n) for _ in range(q.shape[0])]
    stack, _ = encode_plan_batch(plans, align=16)
    assert np.array_equal(stack["perm"], inp[f"{case}/perm"])
    mesh = make_mesh((1, n), ("data", "model"), devices=jax.devices()[:n])
    sh = NamedSharding(mesh, P("data", None, "model", None))
    with set_mesh(mesh):
        ctx = make_cp_context(
            mesh, {k_: jnp.asarray(v_) for k_, v_ in stack.items()},
            strategy=get_planner(plan_name).info.exec_style, impl="xla",
            batch_axes=("data",), head_dim=q.shape[-1], q_chunk=64,
            overlap=overlap, kv_comm_dtype="int8")
        q, k, v = (jax.device_put(jnp.asarray(x), sh) for x in (q, k, v))
        o = jax.jit(ctx.attn)(q, k, v)
        g = jax.jit(jax.grad(
            lambda *a: jnp.sum(ctx.attn(*a).astype(jnp.float32) ** 2),
            (0, 1, 2)))(q, k, v)
    for name, x in zip(("o", "dq", "dk", "dv"), (o, *g)):
        out[f"{case}/{name}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's int8 islands (XLA) at N = 2 and 4, plan order."""
    tmp = tmp_path_factory.mktemp("ref_int8")
    q0, k0, v0, _, _ = cp.island_inputs()
    cases = sorted({f"{n},{p},{o}" for n in (2, 4)
                    for p, o, _, _ in ISLANDS})
    arrays = {"doc_lens": cp.DOC_LENS}
    for case in cases:
        n, plan_name, _ = case.split(",")
        perm = cp.plan_stack(plan_name, int(n))["perm"]
        arrays[f"{case}/perm"] = perm
        for name, x in zip("qkv", (q0, k0, v0)):
            arrays[f"{case}/{name}"] = cp.permute(x, perm)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, os.path.join(HERE, "..", "src"),
         str(tmp / "in.npz"), str(tmp / "ref.npz"), *cases],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("island", ISLANDS, ids=map(_key, ISLANDS))
def test_int8_island_matches_reference(wires, reference, island):
    n, res, _ = wires
    got = res[(*island, "int8")]
    for g, name in zip(got, NAMES):
        want = reference[f"{n},{island[0]},{island[1]}/{name}"]
        np.testing.assert_allclose(g, want, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"cp{n} {_key(island)} {name}")


@pytest.mark.parametrize("island", ISLANDS, ids=map(_key, ISLANDS))
def test_int8_within_native_wire_bounds(wires, island):
    n, res, _ = wires
    for g, w, name in zip(res[(*island, "int8")], res[(*island, "native")],
                          NAMES):
        err = _rel(g, w)
        assert err <= WIRE_TOL[name], (n, _key(island), name, err)
        assert err > 0, "the int8 wire moved nothing"


@pytest.mark.parametrize("island", GATHERED, ids=map(_key, GATHERED))
def test_int8_backward_is_straight_through(wires, island):
    n, res, _ = wires
    for g, w, name in zip(res[(*island, "int8")],
                          res[(*island, "native@dq")], NAMES):
        np.testing.assert_allclose(g, w, atol=ST_TOL, rtol=ST_TOL,
                                   err_msg=f"cp{n} {_key(island)} {name}")


def test_int8_wire_bytes(wires):
    """Per rank, the K/V bytes of the int8 forward are (D + 4) / (4 D) of
    the f32 wire's (D int8 values and one f32 scale per row instead of D
    f32 values); the backward's are the native wire's.  The plain
    ring loop stays native, so every case moves bytes only by the wire."""
    n, _, nbytes = wires
    for island in ISLANDS:
        nat, q8 = nbytes[(*island, "native")], nbytes[(*island, "int8")]
        for r in range(n):
            assert nat[r]["forward"] > 0
            assert q8[r]["forward"] * 4 * cp.D == \
                nat[r]["forward"] * (cp.D + 4), (n, island, r)
            assert q8[r]["backward"] == nat[r]["backward"], (n, island, r)


def _budget(n, island, buf_len):
    """The forward wire budget of ``island`` at ``n`` ranks (f32 K/V, the
    test's batch and heads) on an Eq.-5 buffer of ``buf_len``."""
    strat = get_planner(island[0]).info.exec_style
    return island_budget(strat, resolve_overlap(strat, island[2], island[1]),
                         buf_len=buf_len, num_workers=n, kv_heads=cp.HKV,
                         head_dim=cp.D, dtype_bytes=4, batch=cp.B)


@pytest.mark.parametrize("island", ISLANDS, ids=map(_key, ISLANDS))
def test_wire_audit_clean_on_native_islands(wires, island):
    """Every rank's forward bytes by collective kind equal the analytic
    budget (the Eq.-5 bucket's K/V plus, on the hops, the doc/pos
    metadata) within 1%, and the audit finds nothing."""
    n, _, nbytes = wires
    for r, b in enumerate(nbytes[(*island, "native")]):
        budget = _budget(n, island, b["buf_len"])
        assert not audit_wire(b["by_kind"], budget, largest=b["peak"],
                              context=f"cp{n}/rank{r}")
        for kind, cap in budget.allowed.items():
            assert abs(b["by_kind"][kind] - cap) <= 0.01 * cap, \
                (n, island, r, kind, b["by_kind"], cap)


@pytest.mark.parametrize("island", WIDENED, ids=map(_key, WIDENED))
def test_wire_audit_catches_a_doubled_buffer(wires, island):
    """The island on a buffer twice as wide gives the same attention but
    sends more than the plan's bucket: WIRE102 on every rank."""
    n, res, nbytes = wires
    for g, w in zip(res[(*island, "native@2buf")], res[(*island, "native")]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    natural = nbytes[(*island, "native")]
    for r, b in enumerate(nbytes[(*island, "native@2buf")]):
        assert b["buf_len"] == 2 * natural[r]["buf_len"]
        fs = audit_wire(b["by_kind"], _budget(n, island,
                                             natural[r]["buf_len"]))
        assert {f.rule for f in fs} == {"WIRE102"}, fs


def test_wire_audit_catches_an_unbudgeted_kind(wires):
    """A budget that lacks the kind an island used (the hops' permute,
    the monolithic island's all-gather) trips WIRE101."""
    n, _, nbytes = wires
    for island in (ISLANDS[0], ISLANDS[1]):
        b = nbytes[(*island, "native")][0]
        budget = _budget(n, island, b["buf_len"])
        kind = next(iter(budget.allowed))
        assert b["by_kind"][kind] > 0
        fs = audit_wire(b["by_kind"], dataclasses.replace(
            budget, allowed={k: v for k, v in budget.allowed.items()
                             if k != kind}))
        assert {f.rule for f in fs} == {"WIRE101"}, fs


def _jax_quantize(x):
    """The reference's quantization arithmetic (``_quantized_gather``)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
                        / 127.0, 1e-8)
    q8 = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return np.asarray(q8), np.asarray(scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_reference_bit_for_bit(dtype):
    """q8 and the scales equal the reference's, and so the dequantized
    K/V, for random rows, a zero row (the 1e-8 floor) and rows of exact
    half steps (round half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 17, 8)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 4.5])
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
    q8, scale = quantize_int8(t)
    want_q8, want_scale = _jax_quantize(xj)
    np.testing.assert_array_equal(q8.numpy(), want_q8)
    np.testing.assert_array_equal(scale.numpy(), want_scale)
    got = dequantize_int8(q8, scale, t.dtype).float().numpy()
    want = np.asarray((jnp.asarray(want_q8).astype(jnp.float32)
                       * want_scale).astype(xj.dtype).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
