"""The port's CP islands on ``torch.distributed`` (gloo, CPU ranks)
against the JAX package, on the cases of
``tests/multidevice/overlap_check.py``: C 256, B 2, Hq 4, Hkv 2, D 8,
blocks 16, documents [70, 23, 100, 40, 23].

Every island case — {flashcp, llama3, per_doc, ring_zigzag} x {chunked,
none} x {plain, flash twin on flat tables, flash twin on rect tables} —
runs at CP 2 and CP 4, all cases of one CP size in one spawn of ranks.
The ranks' outputs and gradients of sum(o²) are assembled from their
token slices, un-permuted to packed order and held against
``repro.kernels.ref.mha_reference`` on the unpermuted batch at that
script's tolerances (values 2e-4, gradients 5e-4).  One more case runs
the reference's own ``make_cp_context`` at N = 4 (flashcp chunked, XLA)
on four simulated host devices in a subprocess and holds the port's
gloo run against it at 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_cp_ranks as ranks
from repro.kernels.ref import mha_reference
from repro_torch.launch.ranks import spawn_ranks

ATOL, GTOL = 2e-4, 5e-4
REF_TOL = 1e-5
JOIN_TIMEOUT = 240
PLANS = ("flashcp", "llama3", "per_doc", "ring_zigzag")
IMPLS = (("plain", "rect"), ("flash", "flat"), ("flash", "rect"))
CASES = [(p, o, impl, grid) for p in PLANS for o in ("chunked", "none")
         for impl, grid in IMPLS]
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def oracle():
    """mha_reference's output and gradients of sum(o²), packed order."""
    q0, k0, v0, gdoc, gpos = ranks.island_inputs()

    def f(q, k, v):
        return mha_reference(q, k, v, *map(jnp.asarray,
                                           (gdoc, gpos, gdoc, gpos)))

    args = tuple(map(jnp.asarray, (q0, k0, v0)))
    grads = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), (0, 1, 2))(*args)
    return [np.asarray(f(*args)), *(np.asarray(g) for g in grads)]


@pytest.fixture(scope="module", params=[2, 4])
def islands(request, tmp_path_factory):
    """(cp, per-case plan-order [o, dq, dk, dv]) from one spawn."""
    cp = request.param
    out = tmp_path_factory.mktemp(f"cp{cp}")
    spawn_ranks(ranks.island_rank, cp,
                args=(cp, str(out / "store"), str(out), CASES),
                timeout=JOIN_TIMEOUT)
    per_rank = [dict(np.load(out / f"rank{r}.npz")) for r in range(cp)]
    res = {}
    for case in CASES:
        key = ranks.island_case_key(*case)
        res[case] = [np.concatenate([p[f"{key}/{n}"] for p in per_rank],
                                    axis=2)
                     for n in ("o", "dq", "dk", "dv")]
    return cp, res


def _unpermute(x, perm):
    """Plan order (B, H, C_pad, D) -> packed order (B, H, C, D)."""
    out = np.zeros((*x.shape[:2], ranks.C, x.shape[-1]), x.dtype)
    for b in range(x.shape[0]):
        ok = perm[b] >= 0
        out[b][:, perm[b][ok]] = x[b][:, ok]
    return out


@pytest.mark.parametrize("case", CASES,
                         ids=[ranks.island_case_key(*c) for c in CASES])
def test_island_matches_oracle(islands, oracle, case):
    cp, res = islands
    perm = ranks.plan_stack(case[0], cp)["perm"]
    tag = f"cp{cp}/{ranks.island_case_key(*case)}"
    got = [_unpermute(x, perm) for x in res[case]]
    np.testing.assert_allclose(got[0], oracle[0], atol=ATOL, rtol=ATOL,
                               err_msg=tag)
    for g, want, name in zip(got[1:], oracle[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, want, atol=GTOL, rtol=GTOL,
                                   err_msg=f"{tag} {name}")


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
B, D = inp["qp"].shape[0], inp["qp"].shape[-1]
plans = [get_planner("flashcp")(doc_lens, 4) for _ in range(B)]
stack, _ = encode_plan_batch(plans, align=16)
assert np.array_equal(stack["perm"], inp["perm"])
mesh = make_mesh((1, 4), ("data", "model"))
sh = NamedSharding(mesh, P("data", None, "model", None))
with set_mesh(mesh):
    ctx = make_cp_context(mesh, {k: jnp.asarray(v) for k, v in stack.items()},
                          strategy="flashcp", impl="xla",
                          batch_axes=("data",), head_dim=D, q_chunk=64,
                          overlap="chunked")
    q, k, v = (jax.device_put(jnp.asarray(inp[n]), sh)
               for n in ("qp", "kp", "vp"))
    o = jax.jit(ctx.attn)(q, k, v)
    g = jax.jit(jax.grad(
        lambda *a: jnp.sum(ctx.attn(*a).astype(jnp.float32) ** 2),
        (0, 1, 2)))(q, k, v)
np.savez(sys.argv[3], o=np.asarray(o), dq=np.asarray(g[0]),
         dk=np.asarray(g[1]), dv=np.asarray(g[2]))
"""


@pytest.mark.parametrize("islands", [4], indirect=True)
def test_reference_cp_island_matches_gloo_run(islands, tmp_path):
    """The reference's own flashcp chunked island at N = 4 (XLA, four
    simulated host devices) against the port's gloo N = 4 run, in plan
    order, at 1e-5."""
    _, res = islands
    q0, k0, v0, _, _ = ranks.island_inputs()
    perm = ranks.plan_stack("flashcp", 4)["perm"]
    np.savez(tmp_path / "in.npz", doc_lens=ranks.DOC_LENS, perm=perm,
             qp=ranks.permute(q0, perm), kp=ranks.permute(k0, perm),
             vp=ranks.permute(v0, perm))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT,
         os.path.join(HERE, "..", "src"), str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(tmp_path / "ref.npz")
    got = res[("flashcp", "chunked", "plain", "rect")]
    for g, name in zip(got, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, want[name], atol=REF_TOL,
                                   rtol=REF_TOL, err_msg=name)
