"""Per-rank dry run: prove the distribution config is coherent, without
the machines (the port of the reference's ``launch/dryrun.py``).

For every (architecture x input shape) cell, on the single-pod 16x16 mesh
and the 2x16x16 multi-pod mesh, one rank's step is built and run on the
``meta`` device: its ZeRO-3 state (this rank's shards of the
parameters and the optimizer's master, ``mu`` and ``nu``), its rows and
token slice of the batch, its CP islands and ZeRO-3 gathers over a
recording communicator (``core.comm.RecordingComm``: no process group,
no data moved, the bytes counted by kind), under the traced cost
analysis of :mod:`repro_torch.launch.cost_analysis` (FLOPs, bytes, the
peak of live bytes).  Nothing is computed or allocated, so the 512
ranks of the two-pod mesh are one process and a few seconds per cell.
Each record carries the reference's fields (``memory.
peak_bytes_per_device``, ``cost``, ``collectives``, ``roofline``,
``model_flops_per_device``, ``useful_flops_frac``) and ``fits``: the
kernel-adjusted peak (the doc kernels keep the attention scores on chip)
against the card's memory, or the H100's 80 GB where this process has
no card, named as such.  The roofline terms use the H100's constants of
``autotune.cost_model.HW``: a model, not a measurement.

The step traces the plain attention (``attention_impl="plain"``, the
reference's ``"xla"``), and the kernel libraries are forbidden while it
runs (``kernels._build.forbid_kernels``): a ``ctypes`` launch would take
the meta tensors' fake pointers.  Training cells run
``launch.steps.build_train_step``'s step; prefill cells the CP forward
to the last position's logits (the reference's ``build_prefill_step``);
decode cells ``models.decode_step`` with the dense oracle on this
rank's ``cache_specs`` shards (the attention's S slice merged over
``model``; a recurrent state split over ``model`` is gathered for the
step and its slice kept).  No plan is built: the input shapes come from
the reference's ``default_buf_len``, ``train_input_specs`` and
``decode_input_specs``.

Results stream to ``dryrun_results_torch.json`` at the repository root
(incremental, resumable with ``--skip-done``); the reference's
``dryrun_results.json`` is never written.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_32b \\
        --shape train_4k --multi-pod both --strategy flashcp
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses import FakeTensorMode

from repro_torch.configs import SHAPES, RunConfig, get_config
from repro_torch.configs import ARCHS
from repro_torch.core.comm import RecordingComm, all_gather_tiled
from repro_torch.core.cp_attention import make_cp_context
from repro_torch.data.pipeline import exec_style_of
from repro_torch.kernels import _build
from repro_torch.kernels.doc_attention import (flash_bwd_dkv, flash_bwd_dq,
                                               flash_fwd)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.launch.mesh import (AXES, POD_AXES, grid_coords,
                                     production_grid)
from repro_torch.launch.roofline import HW, model_flops, roofline_terms
from repro_torch.launch.steps import (build_train_step, effective_strategy,
                                      rank_batch)
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.optim import adamw_init
from repro_torch.planner.encode import pick_buffer_bucket
from repro_torch.runtime.sharding import (batch_axes_of, cache_specs,
                                          shard_shape, take_shard)
from repro_torch.runtime.zero import Zero3, named_leaves

__all__ = ["default_buf_len", "train_input_specs", "decode_input_specs",
           "cell_skip_reason", "rank_state", "run_cell", "main",
           "RESULTS", "H100_BYTES"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_results_torch.json")
#: the H100's memory, where this process has no card to ask
H100_BYTES = 80e9
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_decode,
           flash_decode_paged)


def default_buf_len(seq_len: int, cp: int) -> int:
    """Static Eq.5 bucket for fixed-shape tracing: half the local KV
    (representative of measured FlashCP savings; the pipeline may emit
    any bucket <= full local KV at runtime)."""
    return pick_buffer_bucket(max(seq_len // (2 * cp), 1), seq_len // cp)


# --------------------------------------------------------------------- #
# input specs: {key: (shape, dtype)}, the pipeline's arrays' stand-ins
# --------------------------------------------------------------------- #
def train_input_specs(cfg, shape, cp: int, *, strategy: str = "flashcp",
                      buf_len: int | None = None,
                      dispatch: bool = False) -> dict:
    """The reference's ``train_input_specs`` for the plain attention (no
    visit tables): the (B, C) token arrays, the Eq.5 exchange arrays of
    the flashcp-style executions, the frontends' inputs."""
    B, C, N = shape.global_batch, shape.seq_len, cp
    buf = buf_len or default_buf_len(C, N)
    i32, dt = torch.int32, _dtype(cfg)
    s = {k: ((B, C), i32) for k in ("tokens", "labels", "doc", "pos")}
    if dispatch:
        s["seq_tokens"] = ((B,), i32)
        s["group_id"] = ((B,), i32)
    if exec_style_of(strategy) in ("flashcp", "contiguous"):
        s["send_idx"] = ((B, N, buf), i32)
        s["gath_doc"] = ((B, N * buf), i32)
        s["gath_pos"] = ((B, N * buf), i32)
    if cfg.frontend == "audio_frames":
        s["frame_embeds"] = ((B, C, cfg.d_model), dt)
        del s["tokens"]
    if cfg.frontend == "vit_patches":
        s["patch_embeds"] = ((B, C, cfg.d_model), dt)
        s["patch_mask"] = ((B, C), torch.bool)
    return s


def decode_input_specs(cfg, shape) -> dict:
    """The reference's ``decode_input_specs``: the step's batch and the
    whole decode cache, ``{"batch": {...}, "cache": {path: ...}}``."""
    B = shape.global_batch
    batch = {"pos_t": ((B,), torch.int32)}
    if cfg.frontend == "audio_frames":
        batch["frame_embeds"] = ((B, cfg.d_model), _dtype(cfg))
    else:
        batch["tokens"] = ((B,), torch.int32)
    return {"batch": batch, "cache": _abstract(
        functools.partial(init_cache, cfg, B, shape.seq_len, device="cpu"))}


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _abstract(make) -> dict:
    """``{path: (shape, dtype)}`` of the tree ``make()`` builds, traced
    under a fake-tensor mode: nothing is allocated."""
    with FakeTensorMode():
        tree = make()
    return {p: (tuple(x.shape), x.dtype) for p, x in named_leaves(tree)}


@functools.lru_cache(maxsize=16)
def _param_specs(cfg) -> dict:
    return _abstract(functools.partial(init_params, cfg, device="cpu"))


def _meta_tree(specs: dict, shapes: dict | None = None) -> dict:
    """A nested dict of uninitialized ``meta`` tensors at ``specs``'
    paths and dtypes, with ``shapes`` in place of their shapes."""
    tree: dict = {}
    for path, (shape, dtype) in specs.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = torch.empty((shapes or {}).get(path, shape),
                                 dtype=dtype, device="meta")
    return tree


def cell_skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k needs sub-quadratic attention; skipped for pure "
                "full-attention arch (DESIGN.md §Arch-applicability)")
    return None


def _logits_shaped(cfg, shape, axes: dict, q_chunk: int) -> set[tuple]:
    """``(shape, dtype)`` of the plain attention's score and mask
    intermediates, what the doc kernels keep on chip (the reference's
    ``_logits_sized`` at the port's chunking, matched by shape rather
    than by byte count, so that an MLP activation of the same size is not
    taken for one): the f32 scores and bool masks ``(b, Hkv, G, qc, tk)``,
    the scores' matmul results ``(b Hkv, G qc, tk)`` and the doc masks
    ``(b, qc, tk)``, for the key lengths tk of the local KV, one hop's
    buffer, the local KV plus the gathered buffers, or the whole
    sequence."""
    if not cfg.uses_attention or shape.kind == "decode":
        return set()
    cp = axes["model"]
    data = math.prod(axes[a] for a in batch_axes_of(axes))
    b = max(shape.global_batch // data, 1)
    tq = shape.seq_len // cp
    qc = q_chunk if tq % q_chunk == 0 else tq
    buf = default_buf_len(shape.seq_len, cp)
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    f32, pred = torch.float32, torch.bool
    out = set()
    for tk in (tq, buf, tq + cp * buf, shape.seq_len):
        out |= {((b, hkv, g, qc, tk), f32), ((b, hkv, g, qc, tk), pred),
                ((b * hkv, g * qc, tk), f32), ((b, qc, tk), pred)}
    return out


# --------------------------------------------------------------------- #
# one rank
# --------------------------------------------------------------------- #
def rank_state(cfg, axes: dict, coords: dict, *, optimizer: bool = True):
    """One rank's ZeRO-3 layout (None at one rank) and its state on the
    ``meta`` device: ``(zero, params, opt)``, the parameters and (with
    ``optimizer``) the AdamW state as this rank's shards, over recording
    communicators of the rank's lines of the mesh."""
    specs = _param_specs(cfg)
    world = math.prod(axes.values())
    zero = None
    shapes = None
    if world > 1:
        rank = 0
        for a in axes:
            rank = rank * axes[a] + coords[a]

        def comm_of(axis):
            if axis is None:
                return RecordingComm(rank, world)
            return RecordingComm(coords[axis], axes[axis])
        zero = Zero3.from_layout(axes, coords,
                                 {p: s for p, (s, _) in specs.items()},
                                 comm_of)
        shapes = zero.shard_shapes()
    params = _meta_tree(specs, shapes)
    opt = adamw_init(params) if optimizer else None
    return zero, params, opt


def state_bytes(params, opt) -> int:
    """Bytes of the parameters and the optimizer state."""
    trees = [params] + ([] if opt is None else [opt])
    return sum(x.numel() * x.element_size() for t in trees
               for _, x in named_leaves(t))


def _wire(zero) -> dict:
    """Wire bytes by kind over every communicator of the rank."""
    out: dict[str, int] = {}
    for c in [] if zero is None else [*zero.comms.values(), zero.world]:
        for k, v in c.wire_bytes_by_kind.items():
            out[k] = out.get(k, 0) + v
    return out


def _train(cfg, shape, axes, coords, run, q_chunk, mode):
    zero, params, opt = rank_state(cfg, axes, coords)
    batch = _meta_tree(train_input_specs(
        cfg, shape, axes["model"], strategy=effective_strategy(
            cfg, run.cp_strategy)))
    step = build_train_step(cfg, run, q_chunk=q_chunk, device="cpu",
                            zero=zero)
    mode.track(params, opt, batch)
    before = mode.live_bytes
    with mode:
        out = step(params, opt, batch, 0)
    return zero, state_bytes(params, opt), before, out


def _prefill(cfg, shape, axes, coords, run, q_chunk, mode):
    zero, params, _ = rank_state(cfg, axes, coords, optimizer=False)
    batch = _meta_tree(train_input_specs(
        cfg, shape, axes["model"], strategy=effective_strategy(
            cfg, run.cp_strategy)))
    del batch["labels"]
    exec_style = exec_style_of(effective_strategy(cfg, run.cp_strategy))
    mode.track(params, batch)
    before = mode.live_bytes
    with mode, torch.no_grad():
        b = batch if zero is None else rank_batch(batch, axes, coords)
        ctx = make_cp_context(
            {k: b[k] for k in b if k in ("doc", "pos", "send_idx",
                                         "gath_doc", "gath_pos")},
            strategy=exec_style, impl="plain",
            head_dim=cfg.resolved_head_dim, q_chunk=q_chunk,
            overlap=run.cp_overlap, kv_comm_dtype=run.kv_comm_dtype,
            comm=None if zero is None else zero.cp,
            world=None if zero is None else zero.world)
        kw = {} if zero is None else {"gather": zero.gather}
        logits, _ = forward(params, cfg, ctx, b, remat=run.remat, **kw)
        out = logits[:, -1, :]
    return zero, state_bytes(params, None), before, out


def _decode(cfg, shape, axes, coords, run, q_chunk, mode):
    zero, params, _ = rank_state(cfg, axes, coords, optimizer=False)
    specs = decode_input_specs(cfg, shape)
    whole = {p: s for p, (s, _) in specs["cache"].items()}
    cspec = cache_specs(axes, whole)
    cache = _meta_tree(specs["cache"], {p: shard_shape(s, cspec[p], axes)
                                        for p, s in whole.items()})
    batch = _meta_tree(specs["batch"])
    baxes = batch_axes_of(axes)
    B = shape.global_batch
    need = math.prod(axes[a] for a in baxes)
    if baxes and B % need == 0:
        entry = baxes if len(baxes) > 1 else baxes[0]
        batch = {k: take_shard(v, (entry,) + (None,) * (v.dim() - 1), axes,
                               coords) for k, v in batch.items()}
    cp = None if zero is None else zero.cp
    mode.track(params, cache, batch)
    before = mode.live_bytes
    with mode, torch.no_grad():
        # recurrent states split over ``model`` are gathered for the step
        # and this rank's slice kept; the attention caches stay split
        held = {}
        step_cache: dict = {}
        for path, x in named_leaves(cache):
            sub, name = path.split("/")
            spec = cspec[path]
            if cp is not None and name not in ("k", "v") and "model" in spec:
                held[path] = (x, spec.index("model"))
                x = all_gather_tiled(x, cp, spec.index("model"))
            step_cache.setdefault(sub, {})[name] = x
        gather = _whole if zero is None else functools.partial(
            zero.gather, experts=True)
        inputs = {k: v for k, v in batch.items() if k != "pos_t"}
        logits, step_cache = decode_step(
            params, cfg, step_cache, inputs, batch["pos_t"],
            attn_impl="dense", gather=gather, cache_comm=cp)
        for path, (x, dim) in held.items():
            sub, name = path.split("/")
            x.copy_(take_shard(step_cache[sub][name],
                               (None,) * dim + ("model",), axes, coords))
    return zero, state_bytes(params, None) + sum(
        x.numel() * x.element_size() for _, x in named_leaves(cache)), \
        before, logits


def _whole(prefix, tree):
    return tree


def device_bytes() -> tuple[float, str]:
    """The card's memory where this process has a card, else the
    H100's 80 GB."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                torch.cuda.get_device_name(0))
    return H100_BYTES, "H100 80 GB (no card in this process)"


def mesh_name(axes: dict) -> str:
    return "x".join(str(n) for n in axes.values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy: str = "flashcp", q_chunk: int = 512,
             remat: bool = True, kv_comm_dtype: str = "native",
             axes: dict | None = None, cfg=None, shape=None) -> dict:
    """The record of one cell: ``arch`` x ``shape_name`` on the
    production mesh (``multi_pod``: 2x16x16, else 16x16), or on the mesh
    ``axes`` (``{axis: size}``), traced as its rank 0.  ``cfg``
    and ``shape`` replace the named config and shape (a cut model, a
    smaller batch)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    t0 = time.time()
    if axes is None:
        grid = production_grid(multi_pod)
        names = POD_AXES if multi_pod else AXES
        axes = dict(zip(names, grid.shape))
    else:
        axes = dict(axes)
        names = tuple(axes)
        grid = torch.arange(math.prod(axes.values())).reshape(
            tuple(axes.values()))
    coords = grid_coords(grid, names, 0)
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name(axes),
            "strategy": effective_strategy(cfg, strategy)}
    reason = cell_skip_reason(cfg, shape)
    if reason:
        return {**base, "status": "skip", "reason": reason}

    run = RunConfig(arch=arch, cp_strategy=strategy, attention_impl="plain",
                    remat=remat, kv_comm_dtype=kv_comm_dtype)
    mode = CostMode(_logits_shaped(cfg, shape, axes, q_chunk))
    launches = [k.launches for k in KERNELS]
    trace = {"train": _train, "prefill": _prefill,
             "decode": _decode}[shape.kind]
    with _build.forbid_kernels("the dry run traces meta tensors"):
        zero, state, arg_bytes, out = trace(cfg, shape, axes, coords, run,
                                            q_chunk, mode)
    if [k.launches for k in KERNELS] != launches:
        raise AssertionError("the dry run launched a kernel")
    outs = [out] if isinstance(out, torch.Tensor) else list(out.values())
    out_bytes = sum(x.numel() * x.element_size() for x in outs)
    cost = mode.summary()
    by_kind = _wire(zero)
    wire = sum(by_kind.values())
    n_dev = math.prod(axes.values())
    flops = cost["flops"]
    terms = roofline_terms(flops, cost["bytes_kernel_adjusted"], wire)
    terms["memory_s_plain_attention"] = cost["bytes"] / HW["hbm_bw"]
    mf = model_flops(cfg, shape, num_devices=n_dev)
    cap, cap_name = device_bytes()
    return {
        **base, "status": "ok", "seconds": round(time.time() - t0, 1),
        "devices": n_dev, "coords": coords,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost["peak_bytes"] - arg_bytes,
            "alias_bytes": 0,
            "peak_bytes_per_device": cost["peak_bytes"],
            "peak_bytes_kernel_adjusted": cost["peak_bytes_kernel_adjusted"],
            "state_bytes": state,
        },
        "fits": cost["peak_bytes_kernel_adjusted"] <= cap,
        "device_bytes": cap, "device": cap_name,
        "cost": {"flops_per_device": flops,
                 "bytes_per_device": cost["bytes"],
                 "bytes_kernel_adjusted": cost["bytes_kernel_adjusted"],
                 "ops": cost["ops"]},
        "collectives": {
            "wire_bytes_per_device": wire,
            "count": len([v for v in by_kind.values() if v]),
            "by_kind": by_kind},
        "roofline": terms,
        "hw": dict(HW),
        "model_flops_per_device": mf,
        "useful_flops_frac": (mf / flops) if flops else None,
    }


def load_results(path: str) -> list[dict]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def save_results(path: str, recs: list[dict]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(recs, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="flashcp")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-comm-dtype", default="native",
                    choices=["native", "int8"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    recs = load_results(args.results)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("strategy", ""))
            for r in recs if r.get("status") in ("ok", "skip")}

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                name = "2x16x16" if mp else "16x16"
                strat = effective_strategy(get_config(arch), args.strategy)
                key = (arch, shape, name, strat)
                if args.skip_done and key in done:
                    continue
                print(f"--- {arch} x {shape} x {name} [{strat}]",
                      flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   strategy=args.strategy,
                                   q_chunk=args.q_chunk,
                                   remat=not args.no_remat,
                                   kv_comm_dtype=args.kv_comm_dtype)
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": name,
                           "strategy": args.strategy, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(rec["error"], flush=True)
                    if args.fail_fast:
                        recs = [r for r in recs if
                                (r["arch"], r["shape"], r["mesh"],
                                 r.get("strategy", "")) != key]
                        recs.append(rec)
                        save_results(args.results, recs)
                        raise
                else:
                    if rec["status"] == "ok":
                        mem = rec["memory"]
                        rf = rec["roofline"]
                        print(f"    ok in {rec['seconds']}s | peak "
                              f"{mem['peak_bytes_kernel_adjusted'] / 1e9:.2f}"
                              f" GB/rank ({mem['peak_bytes_per_device'] / 1e9:.2f}"
                              f" plain) fits {rec['fits']} | compute "
                              f"{rf['compute_s'] * 1e3:.1f}ms mem "
                              f"{rf['memory_s'] * 1e3:.1f}ms coll "
                              f"{rf['collective_s'] * 1e3:.1f}ms -> "
                              f"{rf['dominant']}", flush=True)
                    else:
                        print(f"    skip: {rec['reason']}", flush=True)
                recs = [r for r in recs if
                        (r["arch"], r["shape"], r["mesh"],
                         r.get("strategy", "")) != key]
                recs.append(rec)
                save_results(args.results, recs)

    print(f"\n{len(recs)} records; {failures} failures")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
