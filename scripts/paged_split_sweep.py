#!/usr/bin/env python3
"""Time the port's split kernels on one NVIDIA GPU over their split
and sub-tile settings, at ``chip_smoke.py``'s shapes in bf16, with
``chip_smoke.py``'s timer (L2 flushed, median of 25; 20 for dK/dV and
dQ).  Each setting is checked
against a plain version first.  Prints one JSON line per setting, then
the time of ``chip_smoke.py``'s library yardstick.

* ``paged``: ``flash_decode_paged`` over ``SPLIT_MIN_POSITIONS`` x
  ``SPLIT_BLOCKS_PER_SM`` (gather oracle; SDPA over the gathered view);
* ``dense``: ``flash_decode`` in partial mode over ``DENSE_TILE`` x
  ``SPLIT_MIN_POSITIONS`` x ``SPLIT_BLOCKS_PER_SM`` (dense oracle; SDPA);
* ``dkv``: ``flash_bwd_dkv`` on the step-0 training batch over the key
  parts x group slices of ``dkv_split_plan`` (the twin, at
  ``chip_smoke.DKV_BF16_TOL``; SDPA's backward);
* ``dq``: ``flash_bwd_dq`` on the same batch at each keys-per-sub-tile
  width the bf16 kernel is built with (``DQ_KEY_TILE``; the twin, at
  ``chip_smoke.DOC_TOL``; SDPA's backward).

    python3 scripts/paged_split_sweep.py [paged|dense|dkv|dq ...]
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def sweep_paged(torch, timer, gen, sms) -> None:
    from repro_torch.kernels import flash_decode as fd

    q, kp, vp, ln, tp = cs.paged_case(torch, torch.bfloat16, gen)
    ref = fd.paged_decode_reference(q, kp, vp, ln, tp, block_size=cs.BLOCK)
    saved = fd.SPLIT_MIN_POSITIONS, fd.SPLIT_BLOCKS_PER_SM
    for min_pos in (16, 32, 64, 128):
        for per_sm in (1, 2, 4, 8):
            fd.SPLIT_MIN_POSITIONS, fd.SPLIT_BLOCKS_PER_SM = min_pos, per_sm
            out = fd.flash_decode_paged(q, kp, vp, ln, tp,
                                        block_size=cs.BLOCK)
            err = (out.float() - ref.float()).abs().max().item()
            if err > cs.TOL["bfloat16"]:
                raise AssertionError(f"{min_pos} {per_sm}: error {err}")
            pps, n_split = fd.paged_split_plan(cs.B, cs.HKV, tp.shape[1],
                                               cs.BLOCK, sms)
            ms = timer(lambda: fd.flash_decode_paged(
                q, kp, vp, ln, tp, block_size=cs.BLOCK))
            emit(kernel="flash_decode_paged", min_positions=min_pos,
                 blocks_per_sm=per_sm, pages_per_split=pps, splits=n_split,
                 ms=ms, max_abs_err=err)
    fd.SPLIT_MIN_POSITIONS, fd.SPLIT_BLOCKS_PER_SM = saved
    kv_view = [fd.gather_paged_kv(x, tp, cs.BLOCK) for x in (kp, vp)]
    mask = (torch.arange(kv_view[0].shape[2], device="cuda")[None, :]
            <= ln[:, None].long())[:, None, None, :]
    emit(kernel="flash_decode_paged", library_ms=timer(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], *kv_view, attn_mask=mask, enable_gqa=True)))


def sweep_dense(torch, timer, gen, sms) -> None:
    from repro_torch.core.merge import finalize_partial
    from repro_torch.kernels import flash_decode as fd

    q, k, v, ln = cs.dense_case(torch, torch.bfloat16, gen)
    ref = fd.decode_reference(q, k, v, ln).float()
    saved = fd.DENSE_TILE, fd.SPLIT_MIN_POSITIONS, fd.SPLIT_BLOCKS_PER_SM
    for tile in (16, 32, 64):
        for min_pos in (16, 32, 64, 128):
            for per_sm in (1, 2, 4, 8):
                (fd.DENSE_TILE, fd.SPLIT_MIN_POSITIONS,
                 fd.SPLIT_BLOCKS_PER_SM) = tile, min_pos, per_sm
                part = fd.flash_decode(q, k, v, ln, partial=True)
                err = (finalize_partial(part, torch.float32)
                       - ref).abs().max().item()
                if err > cs.TOL["bfloat16"]:
                    raise AssertionError(f"{tile} {min_pos} {per_sm}: "
                                         f"error {err}")
                pps, n_split = fd.dense_split_plan(cs.B, cs.HKV, cs.S_DENSE,
                                                   sms)
                ms = timer(lambda: fd.flash_decode(q, k, v, ln,
                                                   partial=True))
                emit(kernel="flash_decode", tile=tile,
                     min_positions=min_pos, blocks_per_sm=per_sm,
                     pages_per_split=pps, splits=n_split, ms=ms,
                     max_abs_err=err)
    fd.DENSE_TILE, fd.SPLIT_MIN_POSITIONS, fd.SPLIT_BLOCKS_PER_SM = saved
    pos = torch.arange(cs.S_DENSE, device="cuda")
    mask = (pos[None, :] <= ln[:, None].long())[:, None, None, :]
    emit(kernel="flash_decode", library_ms=timer(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)))


def doc_case(torch, gen):
    """``chip_smoke.py``'s timing inputs of the doc kernels: the step-0
    batch, its flat tables, bf16 q, k, v, dO, and lse, delta."""
    from repro_torch.kernels import doc_attention as da

    batch = cs.doc_batch()
    meta = [batch[k] for k in ("doc", "pos", "doc", "pos")]
    fwd_t, rev_t = cs.doc_tables(batch, "flat")
    q, k, v, do = cs.doc_inputs(torch, gen, torch.bfloat16)
    kw = dict(scale=cs.T_D ** -0.5, block_q=cs.T_BLOCK, block_k=cs.T_BLOCK,
              grid="flat")
    o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return batch, meta, fwd_t, rev_t, (q, k, v, do, lse, delta), kw


def sdpa_backward_ms(torch, timer, batch, q, k, v, do) -> float:
    """SDPA's whole backward (dq, dk, dv) under the batch's doc mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import doc_mask

    mask = doc_mask(batch["doc"], batch["pos"], batch["doc"],
                    batch["pos"])[:, None]
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         enable_gqa=True)
    return timer(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                             retain_graph=True), reps=20)


def sweep_dkv(torch, timer, gen, sms) -> None:
    from repro_torch.kernels import doc_attention as da

    batch, meta, _, rev_t, args, kw = doc_case(torch, gen)
    pdk, pdv = da.flash_bwd_dkv_plain(*args, *meta, rev_t, **kw)
    tol = cs.DKV_BF16_TOL
    rows, G = cs.SEQ // cs.T_BLOCK, cs.T_HQ // cs.T_HKV
    plan = da.dkv_split_plan
    chosen = plan(1, cs.T_HKV, rows, G, cs.T_BLOCK, sms)
    for parts in (1, 2):
        for slices in (1, 2, 3, 4, 6, 12):
            da.dkv_split_plan = lambda *_a, _s=(parts, slices), **_kw: _s
            dk, dv = da.flash_bwd_dkv(*args, *meta, rev_t, **kw)
            rel = max(cs._err(dk, pdk) / pdk.float().abs().max().item(),
                      cs._err(dv, pdv) / pdv.float().abs().max().item())
            if rel > tol:
                raise AssertionError(f"{parts} {slices}: error {rel}")
            ms = timer(lambda: da.flash_bwd_dkv(*args, *meta, rev_t, **kw),
                       reps=20)
            emit(kernel="flash_bwd_dkv", key_parts=parts,
                 group_slices=slices, ctas=rows * cs.T_HKV * parts * slices,
                 chosen=(parts, slices) == chosen, ms=ms, max_rel_err=rel,
                 visits=cs.visits_of(batch))
    da.dkv_split_plan = plan
    emit(kernel="flash_bwd_dkv", library_ms=sdpa_backward_ms(
        torch, timer, batch, *args[:4]))


#: keys per sub-tile that the bf16 dQ kernel is built with
DQ_TILES = (32, 64)


def sweep_dq(torch, timer, gen, sms) -> None:
    from repro_torch.kernels import doc_attention as da

    batch, meta, fwd_t, _, args, kw = doc_case(torch, gen)
    pdq = da.flash_bwd_dq_plain(*args, *meta, fwd_t, **kw)
    tol = cs.DOC_TOL["bfloat16"]
    visits = cs.visits_of(batch)
    flops = visits * cs.T_HQ * cs.MATMULS["flash_bwd_dq"] * 2 \
        * cs.T_BLOCK * cs.T_BLOCK * cs.T_D
    chosen = da.DQ_KEY_TILE
    for tile in DQ_TILES:
        da.DQ_KEY_TILE = tile
        dq = da.flash_bwd_dq(*args, *meta, fwd_t, **kw)
        rel = cs._err(dq, pdq) / pdq.float().abs().max().item()
        if rel > tol:
            raise AssertionError(f"key tile {tile}: error {rel}")
        ms = timer(lambda: da.flash_bwd_dq(*args, *meta, fwd_t, **kw),
                   reps=20)
        emit(kernel="flash_bwd_dq", key_tile=tile, chosen=tile == chosen,
             ms=ms, tflops_per_s=flops / ms / 1e9, max_rel_err=rel,
             visits=visits)
    da.DQ_KEY_TILE = chosen
    emit(kernel="flash_bwd_dq", library_ms=sdpa_backward_ms(
        torch, timer, batch, *args[:4]))


SWEEPS = {"paged": sweep_paged, "dense": sweep_dense, "dkv": sweep_dkv,
          "dq": sweep_dq}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(SWEEPS)
    unknown = sorted(set(names) - set(SWEEPS))
    if unknown:
        print(f"paged_split_sweep: unknown sweeps {unknown}; choose from "
              f"{sorted(SWEEPS)}", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in names:
        SWEEPS[name](torch, timer, gen, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
