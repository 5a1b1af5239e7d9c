#!/usr/bin/env python3
"""The CP islands (native and int8 K/V wire) and the sharded decode over
NCCL, one rank per card, on a host with 4 NVIDIA GPUs.

Runs ``chip_smoke.py``'s ``cp_islands`` phase alone: every island case
at N = 4 and 2 against the one-rank path, then the sharded decode over 2
and 4 ranks (env://) on a random bf16 cache of the main path's shape (B
6, Hkv 2, S 1056, D 128), with the phase's gates.  With fewer cards than
ranks the ranks share a card over gloo, as in ``chip_smoke.py``.

    python3 scripts/cp_islands_nccl.py
"""

from __future__ import annotations

import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("cp_islands_nccl: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit("build", seconds=time.perf_counter() - t0,
            count=torch.cuda.device_count())
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (1, 6, 2, 1056, 128)
    base = types.SimpleNamespace(cache={"sub_0": {
        n: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for n in ("k", "v")}})
    cs.timed(cs.cp_islands_phase, torch, cs.sharded_decode_inputs(torch, base))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        cs.close_rank_pool()
    sys.exit(code)
