"""The port's xLSTM blocks (mLSTM, sLSTM) against the JAX package, on
identical numpy inputs and the reference's own parameters.

* Forward and every gradient in float32, at T the chunk divides (64,
  256), T it does not (48, 100): 1e-5 of each array's largest entry
  (the same f32 products; the chunk-state scan associates its sums in
  another order).
* Decode step by step: each step's output against the forward's token
  and against the reference's step, and the new states against the
  reference's: 1e-5.
* The bfloat16 forward with bf16 parameters (the casts of the
  reference's JAX promotion: f32 gates from a bf16 weight cast up):
  2e-2 of the largest output, a few bf16 roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import context as jctxmod
from repro.models import xlstm as jx
from repro_torch.models import context as tctxmod
from repro_torch.models import xlstm as tx

TOL = 1e-5
BF16_TOL = 2e-2
D, H = 32, 4


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
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)
    assert err <= rel, f"{what}: {err:.3g} of the largest entry > {rel}"


class _Ctx:
    def __init__(self, pos, mod):
        self.pos = pos
        self.extras = {}
        self.ssm_scan = mod.local_ssm_scan
        self.selective_scan = mod.local_selective_scan


def _torch_params(p, dtype=torch.float32):
    out = {}
    for k, v in p.items():
        a = np.asarray(jnp.asarray(v, jnp.float32))
        out[k] = torch.from_numpy(a.copy()).to(dtype)
    return out


def _case(kind, T, seed=0, B=2):
    key = jax.random.PRNGKey(seed)
    p = jx.mlstm_init(key, D, H, expand=2) if kind == "mlstm" \
        else jx.slstm_init(key, D)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = np.tile(np.concatenate([np.arange(T // 3),
                                  np.arange(T - T // 3)]), (B, 1)) \
        .astype(np.int32)
    w = rng.standard_normal((B, T, D)).astype(np.float32)
    return p, x, pos, w


def _apply(mod, kind, p, x, ctx):
    if kind == "mlstm":
        return mod.mlstm_apply(p, x, ctx, num_heads=H)
    return mod.slstm_apply(p, x, ctx)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("T", [48, 64, 100, 256])
def test_forward_and_gradients_match_jax(kind, T):
    p, x, pos, w = _case(kind, T, seed=T)

    def jf(p, x):
        y = _apply(jx, kind, p, x, _Ctx(jnp.asarray(pos), jctxmod))
        return jnp.sum(y * w), y
    (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _torch_params(p).items()}
    tx_ = torch.from_numpy(x).requires_grad_(True)
    got = _apply(tx, kind, tp, tx_,
                 _Ctx(torch.from_numpy(pos), tctxmod))
    _close(got, want, what="y")
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)),
                                [tx_, *tp.values()])
    _close(grads[0], jgx, what="dx")
    for (name, _), g in zip(tp.items(), grads[1:]):
        _close(g, jgp[name], what=f"d{name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_forward_and_jax(kind):
    T, B = 10, 2
    p, x, _, _ = _case(kind, T, seed=3, B=B)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tp = _torch_params(p)
    fwd = _apply(tx, kind, tp, torch.from_numpy(x),
                 _Ctx(torch.from_numpy(pos), tctxmod))
    if kind == "mlstm":
        tcache = {n: v[0] for n, v in tx.mlstm_cache_init(
            1, B, D, H, expand=2, device="cpu").items()}
        jcache = jx.mlstm_cache_init(B, D, H, expand=2, dtype=jnp.float32)
    else:
        tcache = {n: v[0] for n, v in tx.slstm_cache_init(
            1, B, D, device="cpu").items()}
        jcache = jx.slstm_cache_init(B, D, jnp.float32)
    for t in range(T):
        xt = x[:, t]
        if kind == "mlstm":
            y, tcache = tx.mlstm_decode(tp, torch.from_numpy(xt), tcache,
                                        num_heads=H)
            jy, jcache = jx.mlstm_decode(p, jnp.asarray(xt), jcache,
                                         num_heads=H)
        else:
            y, tcache = tx.slstm_decode(tp, torch.from_numpy(xt), tcache)
            jy, jcache = jx.slstm_decode(p, jnp.asarray(xt), jcache)
        _close(y, fwd[:, t], what=f"step {t} vs forward")
        _close(y, jy, what=f"step {t} vs jax")
        for n in tcache:
            _close(tcache[n], jcache[n], what=f"step {t} {n}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_forward_matches_jax(kind):
    p, x, pos, _ = _case(kind, 128, seed=5)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(lambda p, x: _apply(
        jx, kind, p, x, _Ctx(jnp.asarray(pos), jctxmod)))(pb, xb)
    got = _apply(tx, kind, _torch_params(pb, torch.bfloat16),
                 torch.from_numpy(np.asarray(xb.astype(jnp.float32)))
                 .to(torch.bfloat16),
                 _Ctx(torch.from_numpy(pos), tctxmod))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, what="bf16 y")
