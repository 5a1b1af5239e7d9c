#!/usr/bin/env python3
"""Time the port's split-KV ``flash_decode_paged`` on one NVIDIA GPU over
split settings (``SPLIT_MIN_POSITIONS`` x ``SPLIT_BLOCKS_PER_SM``), at
``chip_smoke.py``'s paged shapes in bf16, with ``chip_smoke.py``'s timer
(L2 flushed, median of 25).  Each setting is checked against the gather
oracle first.  Prints one JSON line per setting, then the time of
``chip_smoke.py``'s library yardstick (SDPA over the gathered view).

    python3 scripts/paged_split_sweep.py
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_decode as fd

    print(cs.card_line(), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    q, kp, vp, ln, tp = cs.paged_case(torch, torch.bfloat16, gen)
    ref = fd.paged_decode_reference(q, kp, vp, ln, tp, block_size=cs.BLOCK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            print(json.dumps({"min_positions": min_pos, "blocks_per_sm":
                              per_sm, "pages_per_split": pps,
                              "splits": n_split, "ms": ms, "max_abs_err":
                              err}), flush=True)
    kv_view = [fd.gather_paged_kv(x, tp, cs.BLOCK) for x in (kp, vp)]
    mask = (torch.arange(kv_view[0].shape[2], device="cuda")[None, :]
            <= ln[:, None].long())[:, None, None, :]
    print(json.dumps({"library_ms": timer(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], *kv_view, attn_mask=mask, enable_gqa=True))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
