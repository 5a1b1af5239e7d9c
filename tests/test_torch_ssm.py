"""The port's scans, Mamba mixer and scan islands against the JAX
package, on identical numpy inputs (float32).

* ``local_ssm_scan`` (decay at the state's shape and in broadcast
  shape, with and without ``init``, T that the chunk divides and T that
  it does not) and ``local_selective_scan`` (with and without
  ``init_state``, ``summary_only``), outputs and gradients: 1e-5 of each
  array's largest entry.  The reference's selective scan is a
  sequential ``lax.scan`` over tokens, so this holds the port's
  log-depth doubling against a sequential f32 recurrence; the two
  associate the same sums in another order.
* ``mamba_apply`` (output and every gradient, from the reference's own
  parameters) and ``mamba_decode`` (step by step against the forward,
  and the new states against the reference's): 1e-5.
* The scan islands at N = 2 and 4 (gloo ranks on the CPU) against the
  port's one rank and against the reference's ``make_cp_context(...)``
  islands on simulated host devices, in one subprocess: 1e-5.  The Mamba,
  mLSTM and sLSTM layers through the CP context, against one rank's:
  1e-5.  Documents straddle the rank boundaries, so the Mamba layer
  exercises the causal convolution's halo (a rank without it is wrong
  by O(0.1) there, and the layer must equal the reference's), and the
  mLSTM the halo of its chunk states.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_hybrid_ranks as hranks
from repro.models import context as jctxmod
from repro.models import ssm as jssm
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import context as tctxmod
from repro_torch.models import ssm as tssm

TOL = 1e-5
JOIN_TIMEOUT = 240
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these shapes are tiny, and with the host's
    cores shared by parallel test workers, more threads only wait on
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: {err:.3g} of the largest entry > {rel}"


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# --------------------------------------------------------------------- #
# local_ssm_scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("T,chunk", [(37, 64), (64, 64), (256, 64),
                                     (192, 16)])
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_local_ssm_scan_matches_reference(T, chunk, broadcast, with_init):
    rng = np.random.default_rng(T + chunk)
    B, H, K = 2, 3, 4
    a_shape = (B, T, H, 1, 1) if broadcast else (B, T, H, K, K)
    a = rng.uniform(0.3, 1.0, a_shape).astype(np.float32)
    a[:, T // 3] = 0.0                           # a document start
    x = rng.standard_normal((B, T, H, K, K)).astype(np.float32)
    init = rng.standard_normal((B, H, K, K)).astype(np.float32) \
        if with_init else None
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jf(a, x, init):
        h = jctxmod.local_ssm_scan(a, x, init=init, chunk=chunk)
        return jnp.sum(h * w), h
    jargs = [jnp.asarray(a), jnp.asarray(x),
             None if init is None else jnp.asarray(init)]
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2) if init is not None else (0, 1),
        has_aux=True))(*jargs)
    ta, tx = _t(a, True), _t(x, True)
    ti = None if init is None else _t(init, True)
    got = tctxmod.local_ssm_scan(ta, tx, init=ti, chunk=chunk)
    _close(got.detach(), want, what="h")
    wrt = [ta, tx] + ([ti] if ti is not None else [])
    grads = torch.autograd.grad(torch.sum(got * _t(w)), wrt)
    for name, g, jg in zip(("da", "dx", "dinit"), grads, jgrads):
        _close(g, jg, what=name)


# --------------------------------------------------------------------- #
# local_selective_scan
# --------------------------------------------------------------------- #
def _sel_inputs(T, seed=0, B=2, di=8, S=4):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([np.arange(T // 3),
                          np.arange(T - T // 3)]).astype(np.int32)
    return {"dt": rng.uniform(0.01, 0.3, (B, T, di)).astype(np.float32),
            "A": -np.exp(rng.uniform(0, 2, (di, S))).astype(np.float32),
            "Bm": rng.standard_normal((B, T, S)).astype(np.float32),
            "Cm": rng.standard_normal((B, T, S)).astype(np.float32),
            "xf": rng.standard_normal((B, T, di)).astype(np.float32),
            "reset": np.tile((pos > 0).astype(np.float32), (B, 1)),
            "h0": rng.standard_normal((B, di, S)).astype(np.float32),
            "w": rng.standard_normal((B, T, di)).astype(np.float32)}


SEL_ARGS = ("dt", "A", "Bm", "Cm", "xf", "reset")


@pytest.mark.parametrize("T,chunk", [(64, 64), (100, 64), (192, 32),
                                     (48, 8)])
@pytest.mark.parametrize("with_init", [False, True])
def test_local_selective_scan_matches_reference(T, chunk, with_init):
    inp = _sel_inputs(T, seed=T)
    init = inp["h0"] if with_init else None

    def jf(*args):
        y = jctxmod.local_selective_scan(
            *args, chunk=chunk,
            init_state=None if init is None else jnp.asarray(init))
        return jnp.sum(y * inp["w"]), y
    jargs = [jnp.asarray(inp[k]) for k in SEL_ARGS]
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jargs)
    targs = [_t(inp[k], k != "reset") for k in SEL_ARGS]
    got = tctxmod.local_selective_scan(
        *targs, chunk=chunk, init_state=None if init is None else _t(init))
    _close(got.detach(), want, what="y")
    grads = torch.autograd.grad(torch.sum(got * _t(inp["w"])), targs[:5])
    for name, g, jg in zip(SEL_ARGS, grads, jgrads):
        _close(g, jg, what=f"d{name}")


@pytest.mark.parametrize("T", [64, 96])
def test_selective_scan_summary_matches_reference(T):
    inp = _sel_inputs(T, seed=1)
    jargs = [jnp.asarray(inp[k]) for k in SEL_ARGS]
    want_a, want_h = jctxmod.local_selective_scan(*jargs, chunk=16,
                                                  summary_only=True)
    got_a, got_h = tctxmod.local_selective_scan(
        *[_t(inp[k]) for k in SEL_ARGS], chunk=16, summary_only=True)
    _close(got_a, want_a, what="decay product")
    _close(got_h, want_h, what="final state")
    # the summary seeds the next segment exactly as the whole scan does
    y_whole = tctxmod.local_selective_scan(
        *[_t(np.concatenate([inp[k]] * 2, 1) if k != "A" else inp[k])
          for k in SEL_ARGS], chunk=16)
    y_next = tctxmod.local_selective_scan(
        *[_t(inp[k]) for k in SEL_ARGS], chunk=16, init_state=got_h)
    _close(y_next, y_whole[:, T:], what="seeded segment")


# --------------------------------------------------------------------- #
# the Mamba mixer
# --------------------------------------------------------------------- #
class _Ctx:
    def __init__(self, pos, mod):
        self.pos = pos
        self.extras = {}
        self.selective_scan = mod.local_selective_scan
        self.ssm_scan = mod.local_ssm_scan


def _mamba_case(seed=0, B=2, T=48, d=32, d_state=8, d_conv=4):
    p = jssm.mamba_init(jax.random.PRNGKey(seed), d, expand=2,
                        d_state=d_state, d_conv=d_conv)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    pos = np.tile(np.concatenate([np.arange(T // 4),
                                  np.arange(T - T // 4)]), (B, 1)) \
        .astype(np.int32)
    w = rng.standard_normal((B, T, d)).astype(np.float32)
    return p, x, pos, w, dict(d_state=d_state, d_conv=d_conv)


def test_mamba_apply_and_gradients_match_jax():
    p, x, pos, w, kw = _mamba_case()

    def jf(p, x):
        y = jssm.mamba_apply(p, x, _Ctx(jnp.asarray(pos), jctxmod), **kw)
        return jnp.sum(y * w), y
    (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = {k: _t(np.asarray(v), True) for k, v in p.items()}
    tx = _t(x, True)
    got = tssm.mamba_apply(tp, tx, _Ctx(_t(pos), tctxmod), **kw)
    _close(got.detach(), want, what="y")
    grads = torch.autograd.grad(torch.sum(got * _t(w)),
                                [tx, *tp.values()])
    _close(grads[0], jgx, what="dx")
    for (name, _), g in zip(tp.items(), grads[1:]):
        _close(g, jgp[name], what=f"d{name}")


def test_mamba_decode_matches_forward_and_jax():
    p, x, _, _, kw = _mamba_case(seed=2, T=12)
    B, T, d = x.shape
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tp = {k: _t(np.asarray(v)) for k, v in p.items()}
    fwd = tssm.mamba_apply(tp, _t(x), _Ctx(_t(pos), tctxmod), **kw)
    tcache = {n: leaf[0] for n, leaf in tssm.mamba_cache_init(
        1, B, d, expand=2, dtype=torch.float32, device="cpu",
        **kw).items()}
    jcache = jssm.mamba_cache_init(B, d, expand=2, dtype=jnp.float32, **kw)
    for t in range(T):
        y, tcache = tssm.mamba_decode(tp, _t(x[:, t]), tcache, **kw)
        jy, jcache = jssm.mamba_decode(p, jnp.asarray(x[:, t]), jcache,
                                       **kw)
        _close(y, fwd[:, t], what=f"step {t} vs forward")
        _close(y, jy, what=f"step {t} vs jax")
        for n in ("conv", "ssm"):
            _close(tcache[n], jcache[n], what=f"step {t} {n}")


# --------------------------------------------------------------------- #
# the scan islands and the convolution halo
# --------------------------------------------------------------------- #
REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.core.cp_attention import make_cp_context
from repro.planner import encode_plan_batch, get_planner

inp = dict(np.load(sys.argv[2]))
B, T = inp["x_full"].shape[:2]
out = {}
for n in (2, 4):
    plans = [get_planner("contiguous")(np.array([T]), n) for _ in range(B)]
    stack, _ = encode_plan_batch(plans, align=8)
    assert stack["doc"].shape[1] == T
    mesh = make_mesh((1, n), ("data", "model"), devices=jax.devices()[:n])
    with set_mesh(mesh):
        ctx = make_cp_context(
            mesh, {k: jnp.asarray(v) for k, v in stack.items()
                   if k != "perm"},
            strategy="contiguous", impl="xla", batch_axes=("data",),
            head_dim=8)
        cases = {
            "ssm_bc": (ctx.ssm_scan, ("a_bc", "x_bc")),
            "ssm_full": (ctx.ssm_scan, ("a_full", "x_full")),
            "sel": (lambda *a: ctx.selective_scan(*a, jnp.asarray(
                inp["reset"])), ("dt", "A", "Bm", "Cm", "xf")),
        }
        for key, (fn, names) in cases.items():
            args = tuple(jnp.asarray(inp[k]) for k in names)
            w = jnp.asarray(inp["w_" + key])
            y = jax.jit(fn)(*args)
            g = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                                 argnums=tuple(range(len(args)))))(*args)
            out[f"{n}/{key}/out"] = np.asarray(y)
            for i, gi in enumerate(g):
                out[f"{n}/{key}/g{i}"] = np.asarray(gi)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def reference_islands(tmp_path_factory):
    """The reference's islands at N = 2 and 4 (one subprocess, 4
    simulated host devices)."""
    tmp = tmp_path_factory.mktemp("ref_islands")
    np.savez(tmp / "in.npz", **hranks.island_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, os.path.join(HERE, "..", "src"),
         str(tmp / "in.npz"), str(tmp / "ref.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


def _one_rank(inp):
    ctx = tctxmod.make_local_context(
        torch.zeros((hranks.B, hranks.T), dtype=torch.int32),
        _t(inp["pos"]))
    return hranks.run_scans(ctx, inp, slice(None))


# gradients of leaves every rank holds whole (A, the mixers' parameters)
# are summed over the ranks; the rest are token slices
SUMMED = {"sel/g1"} | {f"{m}/g{i + 1}" for m, leaves in
                       hranks.mixer_params().items()
                       for i in range(len(leaves))}


@pytest.mark.parametrize("n", [2, 4])
def test_scan_islands_and_halo_match_one_rank_and_reference(
        n, tmp_path, reference_islands):
    spawn_ranks(hranks.island_rank, n,
                args=(n, str(tmp_path / "store"), str(tmp_path)),
                timeout=JOIN_TIMEOUT)
    per = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]
    got = {k: (sum(p[k] for p in per) if k in SUMMED
               else np.concatenate([p[k] for p in per], axis=1))
           for k in per[0]}
    inp = hranks.island_inputs()
    one = _one_rank(inp)
    assert set(got) == set(one)
    for k in got:
        _close(got[k], one[k], what=f"N={n} {k} vs one rank")
    for k, want in reference_islands.items():
        m, rest = k.split("/", 1)
        if int(m) == n:
            _close(got[rest], want, what=f"N={n} {rest} vs reference")
    # the halo matters: a rank that sees zeros before its first token is
    # wrong where a document straddles its boundary
    t_loc = hranks.T // n
    sl = slice(t_loc, 2 * t_loc)
    ctx = tctxmod.make_local_context(
        torch.zeros((hranks.B, t_loc), dtype=torch.int32),
        _t(inp["pos"][:, sl]))
    p = {k: _t(v) for k, v in hranks.mixer_params()["mamba"].items()}
    alone = tssm.mamba_apply(p, _t(inp["x_m"][:, sl]), ctx,
                             d_state=hranks.S, d_conv=hranks.D_CONV)
    assert inp["pos"][0, t_loc] > 0
    assert np.abs(alone.detach().numpy()
                  - one["mamba/out"][:, sl]).max() > 1e-2


def test_halo_layer_matches_reference_forward():
    """The Mamba layer of the island test, one rank, against the
    reference's (whose CP halo is GSPMD's, equal to one device's)."""
    inp = hranks.island_inputs()
    p = hranks.mixer_params()["mamba"]
    want = jssm.mamba_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(inp["x_m"]),
        _Ctx(jnp.asarray(inp["pos"]), jctxmod), d_state=hranks.S,
        d_conv=hranks.D_CONV)
    _close(_one_rank(inp)["mamba/out"], want, what="mamba layer")
