"""Rank bodies of the port's recurrent-family tests (torch and numpy
only, so the spawned ranks never import JAX).

:func:`island_rank` runs the scan islands and the three recurrent
mixers (whose Mamba convolution and mLSTM chunk states cross the rank
boundary through the halo) of one CP rank over gloo on the CPU and
writes its results to ``<out_dir>/rank<r>.npz``; the test process
assembles the
ranks' token slices and holds them against one rank and against the
JAX package's islands.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cp_attention import make_cp_context
from repro_torch.launch.ranks import init_rank
from repro_torch.models.ssm import mamba_apply
from repro_torch.models.xlstm import mlstm_apply, slstm_apply

# B rows of T tokens; the mLSTM-like scan (decay (B, T, H, 1, 1), state
# (B, T, H, K, K)), the sLSTM-like one (both (B, T, DM)), the selective
# scan (d_inner DI, d_state S) and one layer of each mixer of width DM
B, T, H, K, DM, DI, S, D_CONV = 2, 64, 2, 4, 16, 32, 4, 4
# per row, the intra-document positions: documents of 20 + 30 + 14
# tokens, so one straddles the rank boundary at N = 2 (token 32) and
# two do at N = 4 (tokens 16 and 48)
DOCS = (20, 30, 14)
SCAN_KEYS = ("ssm_bc", "ssm_full", "sel", "mamba", "mlstm", "slstm")


def positions():
    pos = np.concatenate([np.arange(n) for n in DOCS]).astype(np.int32)
    return np.tile(pos, (B, 1))


def island_inputs():
    """The scan operands and the output weights of the test losses
    sum(out * w), from seed 0."""
    rng = np.random.default_rng(0)
    pos = positions()
    reset = (pos > 0).astype(np.float32)
    f32 = np.float32
    inp = {
        "a_bc": (rng.uniform(0.5, 1.0, (B, T, H, 1, 1))
                 * reset[:, :, None, None, None]).astype(f32),
        "x_bc": rng.standard_normal((B, T, H, K, K)).astype(f32),
        "a_full": (rng.uniform(0.5, 1.0, (B, T, DM))
                   * reset[..., None]).astype(f32),
        "x_full": rng.standard_normal((B, T, DM)).astype(f32),
        "dt": rng.uniform(0.01, 0.2, (B, T, DI)).astype(f32),
        "A": -np.exp(rng.uniform(0.0, 2.0, (DI, S))).astype(f32),
        "Bm": rng.standard_normal((B, T, S)).astype(f32),
        "Cm": rng.standard_normal((B, T, S)).astype(f32),
        "xf": rng.standard_normal((B, T, DI)).astype(f32),
        "reset": reset,
        "pos": pos,
        "x_m": rng.standard_normal((B, T, DM)).astype(f32),
    }
    for k in SCAN_KEYS:
        shape = inp["x_bc"].shape if k == "ssm_bc" else \
            inp["xf"].shape if k == "sel" else inp["x_full"].shape
        inp[f"w_{k}"] = rng.standard_normal(shape).astype(f32)
    return inp


def mixer_params():
    """One Mamba layer (d 16, expand 2, d_state 4, d_conv 4), one mLSTM
    (H 2 heads of 16) and one sLSTM, f32: {mixer: {leaf: array}}."""
    rng = np.random.default_rng(1)
    r = max(1, DM // 16)

    def he(shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    mamba = {"in_proj": he((DM, 2 * DI), DM),
             "conv_w": he((D_CONV, DI), D_CONV),
             "conv_b": np.zeros((DI,), np.float32),
             "x_proj": he((DI, r + 2 * S), DI), "dt_proj": he((r, DI), r),
             "dt_bias": np.full((DI,), -2.0, np.float32),
             "A_log": np.log(np.arange(1, S + 1, dtype=np.float32))[None]
             .repeat(DI, 0),
             "D": np.ones((DI,), np.float32), "out_proj": he((DI, DM), DI)}
    mlstm = {"up": he((DM, 2 * DI), DM), "wq": he((DI, DI), DI),
             "wk": he((DI, DI), DI), "wv": he((DI, DI), DI),
             "wf": he((DI, H), DI), "wi": he((DI, H), DI),
             "down": he((DI, DM), DI)}
    slstm = {n: he((DM, DM), DM) for n in ("wz", "wi", "wf", "wo", "down")}
    return {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}


def scan_outputs(ctx, t, p):
    """{key: (output, [tensors whose gradients are kept])} of the three
    scans and the three mixers, on the token slice of the tensors ``t``
    (which require grad) and the mixers' parameters ``p``."""
    return {
        "ssm_bc": (ctx.ssm_scan(t["a_bc"], t["x_bc"]),
                   [t["a_bc"], t["x_bc"]]),
        "ssm_full": (ctx.ssm_scan(t["a_full"], t["x_full"]),
                     [t["a_full"], t["x_full"]]),
        "sel": (ctx.selective_scan(t["dt"], t["A"], t["Bm"], t["Cm"],
                                   t["xf"], t["reset"]),
                [t["dt"], t["A"], t["Bm"], t["Cm"], t["xf"]]),
        "mamba": (mamba_apply(p["mamba"], t["x_m"], ctx, d_state=S,
                              d_conv=D_CONV),
                  [t["x_m"], *p["mamba"].values()]),
        "mlstm": (mlstm_apply(p["mlstm"], t["x_m"], ctx, num_heads=H),
                  [t["x_m"], *p["mlstm"].values()]),
        "slstm": (slstm_apply(p["slstm"], t["x_m"], ctx),
                  [t["x_m"], *p["slstm"].values()]),
    }


def run_scans(ctx, inp, sl):
    """Outputs and gradients of sum(out * w) for every scan key on the
    token slice ``sl``: ``{key/out, key/g<i>}`` as numpy."""
    t = {k: torch.from_numpy(np.ascontiguousarray(
        v[:, sl] if v.ndim >= 2 and k != "A" else v))
        for k, v in inp.items()}
    for k in ("a_bc", "x_bc", "a_full", "x_full", "dt", "A", "Bm", "Cm",
              "xf", "x_m"):
        t[k].requires_grad_(True)
    p = {m: {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in leaves.items()}
         for m, leaves in mixer_params().items()}
    res = {}
    for key, (out, wrt) in scan_outputs(ctx, t, p).items():
        grads = torch.autograd.grad(torch.sum(out * t[f"w_{key}"]), wrt)
        res[f"{key}/out"] = out.detach().numpy()
        res.update({f"{key}/g{i}": g.numpy() for i, g in enumerate(grads)})
    return res


def island_rank(rank, world, store, out_dir):
    """This rank's scans and mixers on its T / N tokens through the CP
    context's islands and halo."""
    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        inp = island_inputs()
        pos = torch.from_numpy(inp["pos"])
        arrays = {"doc": torch.zeros((B, T), dtype=torch.int32), "pos": pos,
                  "send_idx": torch.full((B, world, 16), -1)}
        ctx = make_cp_context(arrays, head_dim=8, comm=comm)
        t_loc = T // world
        res = run_scans(ctx, inp, slice(rank * t_loc, (rank + 1) * t_loc))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
