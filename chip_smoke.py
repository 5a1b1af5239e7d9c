#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card (f32 and
bf16), times it beside its memory bound, its plain version and a
library call, then drives the serving path end to end at the full width
of starcoder2_3b (30 layers, d_model 3072, random weights from a seed):
12 requests on 6 slots through the paged layout (``flash_decode_paged``)
and the dense layout (``flash_decode`` in partial mode), gated on every
request ending ok and on the kernels' launch counts.  A small f32 model
served on the card and on the CPU (the plain path) must give the same
tokens.

Run from the repository root:

    python3 chip_smoke.py            # everything (one GPU)
    python3 chip_smoke.py --quick    # build + kernel parity only

Prints one JSON line per phase, the card's name and power limit, the
kernel table, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when a phase fails or there is no
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no TF32
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
# Pallas TPU kernels replaced (function definition lines)
REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:156",
            "flash_decode_paged": "src/repro/kernels/flash_decode.py:282"}

# kernel-parity shapes: full-width starcoder2_3b heads, the serving batch
B, HQ, HKV, D = 6, 24, 2, 128
S_DENSE, BLOCK = 1056, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call: L2 flushed first, then the GPU is kept
    busy while the host enqueues, so host launch overhead is hidden."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 25, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(4_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(read_bytes: int, write_bytes: int, flops: int, dtype: str):
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------- #
# kernels: parity and timing
# ----------------------------------------------------------------------- #
def dense_case(torch, dtype, gen):
    q = torch.randn((B, HQ, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, HKV, S_DENSE, D), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((B, HKV, S_DENSE, D), generator=gen,
                    device="cuda").to(dtype)
    lengths = torch.tensor([-1, 0, S_DENSE - 1, 517, 800, 1023],
                           dtype=torch.int32, device="cuda")
    return q, k, v, lengths


def paged_case(torch, dtype, gen):
    """Pool of 6 * 66 + 8 blocks of 16; tables drawn from a shuffled
    pool, row 1 sharing row 0's first two blocks, table slots past each
    length left 0, and an empty row."""
    nk = S_DENSE // BLOCK
    nb = B * nk + 8
    k_pool = torch.randn((HKV, nb * BLOCK, D), generator=gen,
                         device="cuda").to(dtype)
    v_pool = torch.randn((HKV, nb * BLOCK, D), generator=gen,
                         device="cuda").to(dtype)
    lengths = [1000, 700, S_DENSE - 1, 0, 333, -1]
    perm = torch.randperm(nb, generator=gen, device="cuda").cpu().tolist()
    tables = torch.zeros((B, nk), dtype=torch.int32)
    for b, ln in enumerate(lengths):
        need = ln // BLOCK + 1 if ln >= 0 else 0
        tables[b, :need] = torch.tensor(perm[b * nk:b * nk + need])
    tables[1, :2] = tables[0, :2]
    q = torch.randn((B, HQ, D), generator=gen, device="cuda").to(dtype)
    return (q, k_pool, v_pool,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            tables.to("cuda"))


def visible_positions(lengths) -> int:
    return int(sum(max(int(x) + 1, 0) for x in lengths.tolist()))


def kernel_phase(torch, timer, quick: bool) -> dict:
    import torch.nn.functional as F
    from repro_torch.core.merge import finalize_partial
    from repro_torch.kernels import flash_decode as fd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    err = {"flash_decode": 0.0, "flash_decode_paged": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        q, k, v, ln = dense_case(torch, dtype, gen)
        out = fd.flash_decode(q, k, v, ln)
        torch.cuda.synchronize()
        ref = fd.decode_reference(q, k, v, ln)
        e_norm = (out.float() - ref.float()).abs().max().item()
        o, m, l = fd.flash_decode(q, k, v, ln, partial=True)
        torch.cuda.synchronize()
        _, pm, pl = fd.decode_partial_reference(q, k, v, ln)
        e_part = (finalize_partial((o, m, l), torch.float32)
                  - ref.float()).abs().max().item()
        e_m = (m[1:] - pm[1:]).abs().max().item()
        e_l = ((l[1:] - pl[1:]).abs() / pl[1:]).max().item()
        empty_ok = bool((o[0] == 0).all() and (l[0] == 0).all()
                        and (m[0] == -1e30).all() and (out[0] == 0).all())
        qp, kp, vp, lp, tp = paged_case(torch, dtype, gen)
        outp = fd.flash_decode_paged(qp, kp, vp, lp, tp, block_size=BLOCK)
        torch.cuda.synchronize()
        refp = fd.paged_decode_reference(qp, kp, vp, lp, tp,
                                         block_size=BLOCK)
        e_paged = (outp.float() - refp.float()).abs().max().item()
        emit("kernel_parity", dtype=name, tol=tol,
             flash_decode_err=e_norm, flash_decode_partial_err=e_part,
             partial_m_err=e_m, partial_l_rel_err=e_l,
             flash_decode_paged_err=e_paged, empty_row_exact=empty_ok)
        if max(e_norm, e_part, e_paged) > tol or not empty_ok \
                or e_m > tol or e_l > max(tol, 1e-5):
            raise AssertionError(f"kernel parity failed in {name}")
        err["flash_decode"] = max(err["flash_decode"], e_norm, e_part)
        err["flash_decode_paged"] = max(err["flash_decode_paged"], e_paged)
    if quick:
        return {"err": err}

    # times at the same shapes in the model dtype (bf16)
    dt, esize = torch.bfloat16, 2
    q, k, v, ln = dense_case(torch, dt, gen)
    qp, kp, vp, lp, tp = paged_case(torch, dt, gen)
    kv_view = fd.gather_paged_kv(kp, tp, BLOCK), fd.gather_paged_kv(vp, tp,
                                                                    BLOCK)
    pos = torch.arange(S_DENSE, device="cuda")

    def sdpa(qq, kk, vv, lens):
        mask = (pos[None, :] <= lens[:, None].long())[:, None, None, :]
        return F.scaled_dot_product_attention(qq[:, :, None], kk, vv,
                                              attn_mask=mask,
                                              enable_gqa=True)

    times = {}
    for name, call, plain, lib, lens, extra_in, out_b in (
            ("flash_decode",
             lambda: fd.flash_decode(q, k, v, ln, partial=True),
             lambda: fd.decode_partial_reference(q, k, v, ln),
             lambda: sdpa(q, k, v, ln), ln, 0, B * HQ * (D + 2) * 4),
            ("flash_decode_normalized",
             lambda: fd.flash_decode(q, k, v, ln),
             lambda: fd.decode_reference(q, k, v, ln),
             lambda: sdpa(q, k, v, ln), ln, 0, B * HQ * D * esize),
            ("flash_decode_paged",
             lambda: fd.flash_decode_paged(qp, kp, vp, lp, tp,
                                           block_size=BLOCK),
             lambda: fd.paged_decode_reference(qp, kp, vp, lp, tp,
                                               block_size=BLOCK),
             lambda: sdpa(qp, *kv_view, lp), lp, tp.numel() * 4,
             B * HQ * D * esize)):
        vis = visible_positions(lens)
        read = (B * HQ * D + 2 * vis * HKV * D) * esize + B * 4 + extra_in
        bms, by = bound_ms(read, out_b, 4 * vis * (HQ // HKV) * HKV * D,
                           "bfloat16")
        times[name] = {"ms": timer(call), "plain_ms": timer(plain),
                       "library_ms": timer(lib), "bound_ms": bms,
                       "bound_by": by, "bytes": read + out_b}
        emit("kernel_time", name=name, dtype="bfloat16", **times[name])
    return {"err": err, "times": times}


# ----------------------------------------------------------------------- #
# the serving path
# ----------------------------------------------------------------------- #
def requests(cfg, n=12, lo=256, hi=1024, prefix=128, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, cfg.vocab_size, prefix)
    lens = rng.integers(lo, hi + 1, n)
    lens[0] = hi
    return [np.concatenate([sys_prompt,
                            rng.integers(0, cfg.vocab_size, int(t) - prefix)])
            .astype(np.int32) for t in lens]


def serve_run(torch, cfg, params, layout, prompts, gen, device="cuda",
              **kw):
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serve import ServeEngine

    max_len = max(len(p) for p in prompts) + gen
    eng = ServeEngine(cfg, params, device=device, kv_layout=layout,
                      max_len=max_len, prefix_cache=True, **kw)
    eng.warmup()
    for p in prompts:
        eng.submit(p, max_new=gen)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0
    fd.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    launches = {"flash_decode": fd.flash_decode.launches,
                "flash_decode_paged": fd.flash_decode_paged.launches}
    bad = {r: e["status"] for r, e in results.items() if e["status"] != "ok"}
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"{layout}: requests not ok: {bad}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return eng, results, launches, wall, peak


def main_path_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params

    cfg = get_config("starcoder2_3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, params=cfg.param_count(),
         seconds=time.perf_counter() - t0,
         param_bytes=torch.cuda.memory_allocated())
    prompts = requests(cfg)
    gen = 32
    kw = dict(num_slots=6, prefill_chunk=128, block_size=16)
    out, tokens = {}, {}
    for layout, kernel in (("paged", "flash_decode_paged"),
                           ("dense", "flash_decode")):
        eng, res, launches, wall, peak = serve_run(torch, cfg, params,
                                                   layout, prompts, gen,
                                                   **kw)
        s = eng.stats
        want = s["decode_steps"] * cfg.num_layers
        tp = eng.throughput()
        lat = eng.latency_percentiles()
        emit(f"serve_{layout}", arch=cfg.name, requests=len(prompts),
             slots=kw["num_slots"], prompt_lens=[len(p) for p in prompts],
             gen=gen, wall_s=wall, **tp, stats={
                 k: v for k, v in s.items() if not isinstance(v, dict)},
             launches=launches, expected_launches=want,
             pool=None if eng.pool is None else eng.pool.stats(),
             prefix=None if eng.prefix is None else eng.prefix.stats(),
             kv_cache_bytes=eng.kv_cache_bytes(), peak_bytes=peak,
             latency=lat)
        if launches[kernel] != want or launches[kernel] == 0:
            raise AssertionError(f"{layout}: {kernel} launched "
                                 f"{launches[kernel]} times, want {want}")
        out[layout] = {"launches": launches[kernel], "eng": eng, **tp}
        tokens[layout] = {r: e["tokens"] for r, e in res.items()}
    agree = sum(int((tokens["paged"][r] == tokens["dense"][r]).all())
                for r in tokens["paged"])
    emit("paged_vs_dense_tokens", identical_requests=agree,
         of=len(prompts))

    # one decode step from one cache state: flash kernel vs dense oracle
    eng = out["dense"]["eng"]
    gen_t = torch.Generator(device="cuda")
    gen_t.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (6,), generator=gen_t,
                         device="cuda")
    pos = torch.tensor([255, 400, 600, 800, 1000, 1054], dtype=torch.int32,
                       device="cuda")
    logits = {}
    for impl in ("flash", "dense"):
        cache = {j: {n: t.clone() for n, t in sub.items()}
                 for j, sub in eng.cache.items()}
        logits[impl] = decode_step(params, cfg, cache, {"tokens": toks},
                                   pos, attn_impl=impl)[0].float()
    diff = (logits["flash"] - logits["dense"]).abs().max().item()
    scale = logits["dense"].abs().max().item()
    emit("decode_step_flash_vs_dense", max_abs_diff=diff,
         max_abs_logit=scale, limit=0.02 * scale)
    if not diff <= 0.02 * scale:
        raise AssertionError("flash and dense decode steps disagree")
    out["profile"] = profile_decode(torch, eng, cfg, params)
    return out


def profile_decode(torch, eng, cfg, params) -> dict:
    """Device time by kernel over three dense-layout decode steps, and
    the device's idle share of their wall time (informational)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step

    toks = torch.zeros((6,), dtype=torch.long, device="cuda")
    pos = torch.tensor([300, 500, 700, 900, 1000, 1050], dtype=torch.int32,
                       device="cuda")
    cache = {j: {n: t.clone() for n, t in sub.items()}
             for j, sub in eng.cache.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            decode_step(params, cfg, cache, {"tokens": toks}, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    rows = []
    total = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key, dev_us / 3 / 1e3, ev.count // 3))
            total += dev_us / 3 / 1e3
    rows.sort(key=lambda r: -r[1])
    res = {"wall_ms_per_step": wall * 1e3,
           "device_busy_ms_per_step": total,
           "idle_share": None if not total else max(0.0, 1 - total
                                                    / (wall * 1e3)),
           "top": [{"name": n[:80], "ms": ms, "calls": c}
                   for n, ms, c in rows[:10]]}
    emit("profile_dense_decode_step", **res)
    return res


def smoke_parity_phase(torch) -> None:
    """A small f32 model served on the card and on the CPU (the kernels'
    plain versions) must produce the same greedy tokens."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params

    cfg = reduce_for_smoke(get_config("starcoder2_3b"))
    params_cpu = init_params(cfg, seed=3, device="cpu")
    params_gpu = _to(params_cpu, "cuda")
    prompts = requests(cfg, n=6, lo=20, hi=60, prefix=16, seed=4)
    kw = dict(num_slots=3, prefill_chunk=16, block_size=16)
    for layout in ("paged", "dense"):
        toks = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            _, res, launches, _, _ = serve_run(torch, cfg, params, layout,
                                               prompts, 12, device=dev, **kw)
            toks[dev] = {r: e["tokens"].tolist() for r, e in res.items()}
            if dev == "cuda" and not sum(launches.values()):
                raise AssertionError("smoke run launched no kernel")
        same = toks["cuda"] == toks["cpu"]
        emit("smoke_cuda_vs_cpu_tokens", layout=layout, identical=same)
        if not same:
            raise AssertionError(f"{layout}: cuda and cpu tokens differ")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel parity only")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _, log = _build.build("flash_decode.cu")
    print(log, file=sys.stderr)
    _build.flash_decode_lib()
    emit("build", seconds=time.perf_counter() - t0, source=KERNEL_SOURCE)

    timer = Timer(torch)
    kern = kernel_phase(torch, timer, args.quick)
    kernels = []
    if not args.quick:
        serving = main_path_phase(torch)
        smoke_parity_phase(torch)
        for name, layout in (("flash_decode", "dense"),
                             ("flash_decode_paged", "paged")):
            t = kern["times"][name]
            kernels.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name],
                "launches": serving[layout]["launches"],
                "max_abs_err": kern["err"][name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
