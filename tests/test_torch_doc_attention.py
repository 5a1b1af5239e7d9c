"""The port's doc-attention tables, kernel twins and ops against the JAX
package, on identical numpy inputs.

Tables and queues must be bit-identical.  The twins (what the port's
kernel wrappers run on CPU tensors) are held against the reference's
Pallas kernels in interpret mode, as the JAX tests run them on the CPU.
Tolerances: f32 2e-5 on the forward and 5e-4 on the backward — the same
arithmetic in another summation order (observed differences are ~1e-6);
bf16 3e-2, where one bf16 rounding of p (forward) or dS (dQ) at a
slightly different value flips the last bit of a few products.  A masking,
clamp or empty-row error is O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.doc_attention as jda
from repro.core.cp_attention import finalize_partial as jax_finalize
from repro.core.cp_attention import merge_partials as jax_merge
from repro.kernels.ops import doc_attention_xla, doc_flash_attention
from repro.planner import encode_plan_batch, get_planner
from repro.planner import emit_visit_tables as jax_emit
from repro_torch.core.merge import finalize_partial, merge_partials
from repro_torch.kernels import doc_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.planner import emit_visit_tables

FWD_TOL = 2e-5
BWD_TOL = 5e-4
BF16_TOL = 3e-2


def _layout(B, Tq, Tk, n_docs, *, q_pad=0, kv_pad=0, seed=0):
    """The reference tests' layout: sorted random docs, q a subset of kv."""
    rng = np.random.default_rng(seed)
    kv_doc = np.sort(rng.integers(0, n_docs, (B, Tk)).astype(np.int32), 1)
    kv_pos = np.zeros_like(kv_doc)
    for b in range(B):
        for d in np.unique(kv_doc[b]):
            m = kv_doc[b] == d
            kv_pos[b, m] = np.arange(m.sum())
    idx = np.sort(rng.choice(Tk, Tq, replace=False))
    q_doc, q_pos = kv_doc[:, idx].copy(), kv_pos[:, idx].copy()
    if q_pad:
        q_doc[:, -q_pad:] = -1
    if kv_pad:
        kv_doc[:, -kv_pad:] = -1
    return q_doc, q_pos, kv_doc, kv_pos


def _segmented(B, T, seed=3):
    """Two concatenated plan-ordered runs (a local | gathered layout): the
    multi-segment path of the interval builder."""
    rng = np.random.default_rng(seed)
    doc = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        for half in (slice(0, T // 2), slice(T // 2, T)):
            n = T // 2
            cuts = np.sort(rng.choice(np.arange(1, n), 3, replace=False))
            lens = np.diff(np.concatenate([[0], cuts, [n]]))
            base = rng.integers(0, 5)
            doc[b, half] = np.repeat(base + np.arange(len(lens)), lens)
            pos[b, half] = np.concatenate([np.arange(L) + rng.integers(0, 40)
                                           for L in lens])
    return doc, pos, doc.copy(), pos.copy()


LAYOUTS = {
    "padded": lambda: _layout(2, 64, 128, 4, q_pad=3, kv_pad=5),
    "multi_doc": lambda: _layout(2, 128, 128, 9, seed=4),
    "multi_segment": lambda: _segmented(2, 128),
}


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


# --------------------------------------------------------------------- #
# tables
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bq,bk", [(16, 16), (16, 32), (32, 16)])
def test_block_tables_and_queues_bit_identical(layout, bq, bk):
    qd, qp, kd, kp = LAYOUTS[layout]()
    ref = jda.build_block_tables(qd, qp, kd, kp, block_q=bq, block_k=bk)
    got = tda.build_block_tables(qd, qp, kd, kp, block_q=bq, block_k=bk)
    for name in ("kv_idx", "kv_nvis", "q_idx", "q_nvis", "fq_row", "fq_col",
                 "fq_flags", "rq_row", "rq_col", "rq_flags"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.visited_frac == ref.visited_frac
    assert got.full_frac == ref.full_frac
    for pad in (None, ref.fq_row.shape[1] + 5):
        for x, y in zip(jda.build_work_queue(ref.kv_idx, ref.kv_nvis,
                                             pad_to_steps=pad),
                        tda.build_work_queue(ref.kv_idx, ref.kv_nvis,
                                             pad_to_steps=pad)):
            np.testing.assert_array_equal(x, y)


def _plan_stack(N, C=1024, B=2, seed=0):
    rng = np.random.default_rng(seed)
    lens = []
    for _ in range(B):
        cuts = np.sort(rng.choice(np.arange(16, C - 16), 5, replace=False))
        lens.append(np.diff(np.concatenate([[0], cuts, [C]])).astype(np.int64))
    planner = get_planner("flashcp")
    plans = [planner(np.asarray(l), N) for l in lens]
    stack, _ = encode_plan_batch(plans, align=128)
    return stack


@pytest.mark.parametrize("N", [1, 2, 4])
@pytest.mark.parametrize("grid", ["flat", "rect"])
@pytest.mark.parametrize("overlap", ["chunked", "none"])
def test_emit_visit_tables_bit_identical(N, grid, overlap):
    stack = _plan_stack(N)
    args = (stack["doc"], stack["pos"], stack["gath_doc"], stack["gath_pos"])
    kw = dict(num_workers=N, strategy="flashcp", overlap=overlap, grid=grid,
              block_q=64, block_k=64, cache=False)
    ref = jax_emit(*args, **kw)
    got = emit_visit_tables(*args, **kw)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


# --------------------------------------------------------------------- #
# twins vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------- #
def _qkv(B, Hq, Hkv, Tq, Tk, D, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                     (B, Hq, Tq, D))]
    if dtype == "bf16":
        return [jnp.asarray(x).astype(jnp.bfloat16) for x in out]
    return [jnp.asarray(x) for x in out]


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return _t(x)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


# (B, Hq, Hkv, Tq, Tk, D, bq, bk, docs, q_pad, kv_pad, dtype)
KCASES = {
    "G1": (2, 2, 2, 64, 128, 16, 16, 16, 4, 3, 5, "f32"),
    "G2_bq_ne_bk": (2, 4, 2, 64, 128, 16, 16, 32, 4, 3, 5, "f32"),
    "G3": (1, 6, 2, 96, 96, 32, 32, 16, 3, 0, 7, "f32"),
    "empty_rows": (1, 3, 1, 64, 64, 16, 16, 16, 3, 20, 0, "f32"),
    "bf16": (2, 4, 2, 64, 128, 16, 16, 16, 4, 3, 5, "bf16"),
    # the groups of dbrx_132b (6), qwen3_32b (8), starcoder2_7b (9) and
    # granite_34b (48, MQA)
    "G6": (1, 6, 1, 48, 64, 16, 16, 16, 3, 2, 3, "f32"),
    "G8_bf16": (1, 16, 2, 64, 64, 16, 16, 16, 3, 3, 0, "bf16"),
    "G9": (1, 18, 2, 64, 64, 16, 16, 16, 4, 0, 5, "f32"),
    "G48": (1, 48, 1, 32, 64, 16, 16, 16, 3, 2, 2, "f32"),
}


def _kernel_inputs(case):
    B, Hq, Hkv, Tq, Tk, D, bq, bk, docs, q_pad, kv_pad, dtype = KCASES[case]
    qd, qp, kd, kp = _layout(B, Tq, Tk, docs, q_pad=q_pad, kv_pad=kv_pad)
    q, k, v, do = _qkv(B, Hq, Hkv, Tq, Tk, D, dtype)
    tabs = jda.build_block_tables(qd, qp, kd, kp, block_q=bq, block_k=bk)
    tol_f = BF16_TOL if dtype == "bf16" else FWD_TOL
    tol_b = BF16_TOL if dtype == "bf16" else BWD_TOL
    return (qd, qp, kd, kp), (q, k, v, do), tabs, bq, bk, tol_f, tol_b


def _tables(tabs, grid, half):
    arrs = (tabs.fq_row, tabs.fq_col, tabs.fq_flags, tabs.rq_row,
            tabs.rq_col, tabs.rq_flags) if grid == "flat" else \
        (tabs.kv_idx, tabs.kv_nvis, tabs.q_idx, tabs.q_nvis)
    n = len(arrs) // 2
    arrs = arrs[:n] if half == "fwd" else arrs[n:]
    return tuple(jnp.asarray(a) for a in arrs), tuple(_t(a) for a in arrs)


@pytest.mark.parametrize("case", sorted(KCASES))
@pytest.mark.parametrize("grid", ["flat", "rect"])
def test_kernel_twins_match_pallas(case, grid):
    meta, (q, k, v, do), tabs, bq, bk, tol_f, tol_b = _kernel_inputs(case)
    jm = tuple(jnp.asarray(a) for a in meta)
    tm = tuple(_t(a) for a in meta)
    tq, tk, tv, tdo = map(_to_torch, (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    kw = dict(scale=scale, block_q=bq, block_k=bk, grid=grid)
    jf, tf = _tables(tabs, grid, "fwd")
    jr, tr = _tables(tabs, grid, "rev")

    jo, jl = jda.flash_fwd(q, k, v, *jm, jf, interpret=True, **kw)
    to, tl = tda.flash_fwd(tq, tk, tv, *tm, tf, **kw)
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=tol_f, rtol=0)
    jl, tln = np.asarray(jl), tl.numpy()
    np.testing.assert_array_equal(np.isinf(tln), np.isinf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(tln[fin], jl[fin], atol=tol_f, rtol=0)

    # backward inputs: the reference's own forward outputs, delta in f32
    delta = jnp.sum(do.astype(jnp.float32) * jo.astype(jnp.float32), -1)
    tlse, tdelta = _t(jl), _t(delta)
    jdq = jda.flash_bwd_dq(q, k, v, do, jnp.asarray(jl), delta, *jm, jf,
                           interpret=True, **kw)
    tdq = tda.flash_bwd_dq(tq, tk, tv, tdo, tlse, tdelta, *tm, tf, **kw)
    np.testing.assert_allclose(_f32(tdq), _f32(jdq), atol=tol_b, rtol=0)
    jdk, jdv = jda.flash_bwd_dkv(q, k, v, do, jnp.asarray(jl), delta, *jm,
                                 jr, interpret=True, **kw)
    tdk, tdv = tda.flash_bwd_dkv(tq, tk, tv, tdo, tlse, tdelta, *tm, tr,
                                 **kw)
    np.testing.assert_allclose(_f32(tdk), _f32(jdk), atol=tol_b, rtol=0)
    np.testing.assert_allclose(_f32(tdv), _f32(jdv), atol=tol_b, rtol=0)
    if case == "empty_rows":
        # the padded query rows see nothing: o = 0 exactly, lse = -inf
        assert np.all(to.numpy()[:, :, -20:] == 0)
        assert np.all(np.isneginf(tln[:, :, -20:]))
        assert np.all(tdq.numpy()[:, :, -20:] == 0)


@pytest.mark.parametrize("case,slices", [("G2_bq_ne_bk", 2),
                                         ("G2_bq_ne_bk", 3), ("G3", 2),
                                         ("G3", 3), ("bf16", 2), ("G6", 2),
                                         ("G8_bf16", 2), ("G9", 3),
                                         ("G48", 12)])
@pytest.mark.parametrize("grid", ["flat", "rect"])
def test_dkv_split_plain_matches_pallas(case, slices, grid):
    """The bf16 dK/dV kernel's group split in plain form (each slice's
    f32 partial over its heads, the slices summed in order) against the
    Pallas flash_bwd_dkv: uneven slices (G 3 in 2), an empty slice (G 2
    in 3), one head per slice, and the configured archs' plans at 8192
    tokens (G 6 and 8 in 2, 9 in 3, 48 in 12).  Tolerances as the twins':
    f32 5e-4, bf16 3e-2."""
    meta, (q, k, v, do), tabs, bq, bk, _, tol_b = _kernel_inputs(case)
    jm = tuple(jnp.asarray(a) for a in meta)
    tm = tuple(_t(a) for a in meta)
    tq, tk, tv, tdo = map(_to_torch, (q, k, v, do))
    kw = dict(scale=q.shape[-1] ** -0.5, block_q=bq, block_k=bk, grid=grid)
    jf, _ = _tables(tabs, grid, "fwd")
    jr, tr = _tables(tabs, grid, "rev")
    jo, jl = jda.flash_fwd(q, k, v, *jm, jf, interpret=True, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * jo.astype(jnp.float32), -1)
    jdk, jdv = jda.flash_bwd_dkv(q, k, v, do, jl, delta, *jm, jr,
                                 interpret=True, **kw)
    tdk, tdv = tda.flash_bwd_dkv_split_plain(
        tq, tk, tv, tdo, _t(jl), _t(delta), *tm, tr, group_slices=slices,
        **kw)
    assert tdk.dtype == tk.dtype and tdv.dtype == tv.dtype
    np.testing.assert_allclose(_f32(tdk), _f32(jdk), atol=tol_b, rtol=0)
    np.testing.assert_allclose(_f32(tdv), _f32(jdv), atol=tol_b, rtol=0)


# the plan at one 8192-token row of 128-token blocks on 132 SMs, for the
# main path's heads and the configured archs' (Hkv, G)
PINNED_PLANS = {(1, 2, 64, 12, 128): (1, 6),     # starcoder2_3b
                (1, 8, 64, 8, 128): (1, 2),      # qwen3_32b
                (1, 1, 64, 48, 128): (1, 12),    # granite_34b
                (1, 4, 64, 9, 128): (1, 3),      # starcoder2_7b
                (1, 8, 64, 6, 128): (1, 2)}      # dbrx_132b


@pytest.mark.parametrize("B,Hkv,rows,G,bk", [(1, 2, 64, 12, 128),
                                             (2, 2, 8, 3, 64),
                                             (8, 8, 64, 4, 128),
                                             (1, 1, 4, 1, 32),
                                             (1, 2, 6, 12, 96),
                                             (1, 8, 64, 8, 128),
                                             (1, 1, 64, 48, 128),
                                             (1, 4, 64, 9, 128),
                                             (1, 8, 64, 6, 128)])
def test_dkv_split_plan_divides_rows_and_group(B, Hkv, rows, G, bk):
    """Key parts of 16-key warps that divide block_k; group slices a
    divisor of G, the fewest that give DKV_CTAS_PER_SM CTAs per SM (or
    G).  At one 8192-token row of 128-token blocks the group splits 6
    ways at the training heads (Hkv 2, G 12), and 2, 12, 3 and 2 ways at
    qwen3_32b's, granite_34b's, starcoder2_7b's and dbrx_132b's."""
    parts, slices = tda.dkv_split_plan(B, Hkv, rows, G, bk, sms=132)
    assert parts >= 1 and bk % (16 * parts) == 0
    assert slices >= 1 and G % slices == 0
    target = tda.DKV_CTAS_PER_SM * 132
    ctas = B * Hkv * rows * parts
    assert ctas * slices >= target or slices == G
    smaller = [d for d in range(1, slices) if G % d == 0]
    assert all(ctas * d < target for d in smaller)
    if (B, Hkv, rows, G, bk) in PINNED_PLANS \
            and tda.DKV_KEY_PARTS == 1 and tda.DKV_CTAS_PER_SM == 4:
        assert (parts, slices) == PINNED_PLANS[B, Hkv, rows, G, bk]


@pytest.mark.parametrize("dtype,bq,bk,D,want", [
    (torch.bfloat16, 128, 128, 128, "wgmma"),    # the main path's shape
    (torch.bfloat16, 64, 64, 64, "wgmma"),
    (torch.bfloat16, 64, 128, 128, "wgmma"),     # a CP hop's 64 / 128
    (torch.bfloat16, 128, 64, 64, "wgmma"),
    (torch.bfloat16, 48, 64, 64, "mma"),         # block_q 48
    (torch.bfloat16, 16, 64, 128, "mma"),
    (torch.bfloat16, 128, 32, 128, "mma"),       # block_k 32
    (torch.bfloat16, 128, 96, 128, "mma"),
    (torch.bfloat16, 128, 128, 32, "mma"),       # D 32
    (torch.bfloat16, 64, 64, 80, "mma"),
    (torch.float32, 128, 128, 128, "scalar"),
    (torch.float32, 64, 64, 24, "scalar"),       # 96 bytes a row
    (torch.bfloat16, 64, 64, 24, ValueError),    # not a multiple of 16
    (torch.bfloat16, 128, 128, 256, ValueError),  # D over 128
    (torch.bfloat16, 128, 16, 128, ValueError),  # block_k under 32
    (torch.bfloat16, 40, 64, 64, ValueError),    # block_q not /16
    (torch.bfloat16, 256, 128, 128, ValueError),  # block_q over 128
    (torch.float16, 128, 128, 128, TypeError),   # no f16 forward
])
def test_forward_kernel_rule_by_shape(dtype, bq, bk, D, want):
    """Which CUDA forward ``flash_fwd`` launches, from the dtype and the
    shapes alone: bf16 at block_q, block_k and D each 64 or 128 on wgmma,
    the other bf16 shapes on mma.sync, f32 on the scalar kernel; what no
    forward takes raises."""
    if isinstance(want, str):
        assert tda.fwd_kernel_for(dtype, bq, bk, D) == want
    else:
        with pytest.raises(want):
            tda.fwd_kernel_for(dtype, bq, bk, D)


def test_wrappers_raise_on_mixed_devices_and_bad_grid():
    meta, (q, k, v, _), tabs, bq, bk, _, _ = _kernel_inputs("G1")
    tm = tuple(_t(a) for a in meta)
    _, tf = _tables(tabs, "rect", "fwd")
    tq, tk, tv = map(_to_torch, (q, k, v))
    with pytest.raises(ValueError):
        tda.flash_fwd(tq, tk, tv, *tm, tf, scale=0.25, grid="diag")
    with pytest.raises(ValueError):
        tda.flash_fwd(tq, tk, tv, *tm, tf[:1], scale=0.25, grid="rect")
    with pytest.raises(ValueError):
        tda.flash_fwd(tq.to("meta"), tk, tv, *tm, tf, scale=0.25,
                      grid="rect")


@pytest.mark.parametrize("D", [24, 64])
def test_bf16_dq_inputs_take_only_tensor_core_head_dims(D):
    """The dQ wrapper's input check, which runs before any launch: in
    bf16 a head dim that is not a multiple of 16 is refused (the kernel
    runs only on the tensor cores), one that is passes."""
    rng = np.random.default_rng(7)
    doc, pos, _, _ = _layout(1, 256, 256, 3)
    tabs = tda.build_block_tables(doc, pos, doc, pos, block_q=64,
                                  block_k=64)
    fwd_t = tabs.flat_as_torch("cpu")[:3]
    meta = tuple(_t(a) for a in (doc, pos, doc, pos))
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 256, D)))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, D)))
            .to(torch.bfloat16) for _ in range(2))
    lse = torch.zeros((1, 4, 256), dtype=torch.float32)
    args = ("dq", q, k, v, meta, fwd_t, "flat", 64, 64,
            (do, lse, torch.zeros_like(lse)))
    if D % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            tda._check_kernel_inputs(*args)
    else:
        assert tda._check_kernel_inputs(*args) == (
            1, 4, 2, 256, 256, D, 4, fwd_t[0].shape[1])


def test_run_starts_finds_every_row_in_queue_order():
    meta, _, tabs, *_ = _kernel_inputs("empty_rows")
    flags = _t(tabs.fq_flags)
    nq = tabs.kv_nvis.shape[1]
    starts = tda.run_starts(flags, nq).numpy()
    for b in range(flags.shape[0]):
        want = np.flatnonzero(tabs.fq_flags[b] & tda.FLAG_FIRST)
        np.testing.assert_array_equal(starts[b], want)
        assert sorted(tabs.fq_row[b][want]) == list(range(nq))


# --------------------------------------------------------------------- #
# ops: gradients of doc_flash_attention vs jax.grad, plain vs xla
# --------------------------------------------------------------------- #
def _grad_inputs(seed=5):
    qd, qp, kd, kp = _layout(1, 64, 64, 3, q_pad=4, seed=seed)
    q, k, v, do = _qkv(1, 4, 2, 64, 64, 16, seed=seed)
    tabs = jda.build_block_tables(qd, qp, kd, kp, block_q=16, block_k=16)
    return (qd, qp, kd, kp), (q, k, v, do), tabs


def _torch_tabs(tabs, grid):
    arrs = (tabs.fq_row, tabs.fq_col, tabs.fq_flags, tabs.rq_row,
            tabs.rq_col, tabs.rq_flags) if grid == "flat" else \
        (tabs.kv_idx, tabs.kv_nvis, tabs.q_idx, tabs.q_nvis)
    return tuple(_t(a) for a in arrs)


@pytest.mark.parametrize("grid", ["flat", "rect"])
def test_doc_flash_attention_grads_match_jax(grid):
    meta, (q, k, v, w), tabs = _grad_inputs()
    jm = tuple(jnp.asarray(a) for a in meta)
    tm = tuple(_t(a) for a in meta)

    def jloss(q, k, v):
        o = doc_flash_attention(q, k, v, *jm, tabs, grid=grid,
                                interpret=True)
        return jnp.sum(o * w)

    jl, jg = jax.value_and_grad(jloss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = tops.doc_flash_attention(tq, tk, tv, *tm, _torch_tabs(tabs, grid),
                                 block_q=16, block_k=16, grid=grid)
    tl = torch.sum(o * _t(w))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for a, b, nm in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{nm}")


@pytest.mark.parametrize("grid", ["flat", "rect"])
def test_partial_mode_grads_through_lse_match_jax(grid):
    """Partial mode with a loss that uses lse: two KV halves attended
    separately, merged by online LSE, against full attention; gradients
    through both (o, lse) outputs (the dlse fold)."""
    (qd, qp, kd, kp), (q, k, v, w), _ = _grad_inputs(seed=6)
    T = kd.shape[1]
    halves = []
    for lo, hi in ((0, T // 2), (T // 2, T)):
        m = np.zeros_like(kd)
        m[:, lo:hi] = 1
        kdh = np.where(m == 1, kd, -1).astype(np.int32)
        halves.append((kdh, jda.build_block_tables(qd, qp, kdh, kp,
                                                   block_q=16,
                                                   block_k=16)))
    jq, jp, jk = jnp.asarray(qd), jnp.asarray(qp), jnp.asarray(kp)

    def jloss(q, k, v):
        parts = []
        for kdh, tabs in halves:
            o, lse = doc_flash_attention(q, k, v, jq, jp, jnp.asarray(kdh),
                                         jk, tabs, grid=grid,
                                         interpret=True, partial=True)
            m = jnp.maximum(lse, -1e30)
            parts.append((o.astype(jnp.float32), m, jnp.ones_like(m)))
        return jnp.sum(jax_finalize(jax_merge(parts), jnp.float32) * w)

    jl, jg = jax.value_and_grad(jloss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    parts = []
    for kdh, tabs in halves:
        o, lse = tops.doc_flash_attention(
            tq, tk, tv, _t(qd), _t(qp), _t(kdh), _t(kp),
            _torch_tabs(tabs, grid), block_q=16, block_k=16, grid=grid,
            partial=True)
        m = torch.clamp(lse, min=-1e30)
        parts.append((o.float(), m, torch.ones_like(m)))
    tl = torch.sum(finalize_partial(merge_partials(parts), torch.float32)
                   * _t(w))
    tl.backward()
    # a sum of 4096 unit-scale products: two f32 summation orders differ
    # by ~1e-5 of it, while the merged outputs agree to ~4e-7
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    for a, b, nm in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        assert np.all(np.isfinite(a.numpy())), nm
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{nm}")


@pytest.mark.parametrize("q_chunk", [16, 64])
@pytest.mark.parametrize("partial", [False, True])
def test_doc_attention_plain_matches_xla(q_chunk, partial):
    (qd, qp, kd, kp), (q, k, v, w), _ = _grad_inputs(seed=7)
    jm = tuple(jnp.asarray(a) for a in (qd, qp, kd, kp))
    tm = tuple(_t(a) for a in (qd, qp, kd, kp))

    def jf(q, k, v):
        out = doc_attention_xla(q, k, v, *jm, q_chunk=q_chunk,
                                partial=partial)
        if partial:
            o, m, l = out
            return jnp.sum(o * w) + jnp.sum(l) + jnp.sum(
                jnp.where(m > -1e29, m, 0.0)), out
        return jnp.sum(out * w), out

    (jl, jout), jg = jax.value_and_grad(jf, (0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    tout = tops.doc_attention_plain(tq, tk, tv, *tm, q_chunk=q_chunk,
                                    partial=partial)
    if partial:
        o, m, l = tout
        tl = torch.sum(o * _t(w)) + l.sum() + torch.where(
            m > -1e29, m, 0.0).sum()
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=FWD_TOL, rtol=1e-6)
    else:
        tl = torch.sum(tout * _t(w))
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   atol=FWD_TOL, rtol=0)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for a, b, nm in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{nm}")
