#!/usr/bin/env python3
"""How far xlstm_350m's step-0 gradients move when only the order of
their sums changes, on one NVIDIA GPU.

Full-width, full-depth xlstm_350m in f32 on step 0 of the
``chip_smoke.SEQ``-token wlb_llm stream, one rank: the loss and the
gradients at the mLSTM's chunk of 64 tokens against those at 32 and at
128.  The chunk changes only how the same sums associate (the intra-chunk
products and the chunk-state scan), so the spread bounds what a 1x4 CP
step, which chunks each rank's tokens on its own, can be held to
(``chip_smoke.XLSTM_CP_LEAF_TOL``).  Prints one JSON line: per chunk,
the loss difference, the whole gradient's relative error and the leaves
that moved most.

    python3 scripts/xlstm_chunk_spread.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    import repro_torch.models.xlstm as xl

    if not torch.cuda.is_available():
        print("xlstm_chunk_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    base = xl._CHUNK
    loss0, g0 = cs.step0_grads("float32", layers=0, seq=cs.SEQ,
                               arch=cs.XLSTM)
    out = {}
    for chunk in (base // 2, base * 2):
        xl._CHUNK = chunk
        loss, g = cs.step0_grads("float32", layers=0, seq=cs.SEQ,
                                 arch=cs.XLSTM)
        r = cs.compare_grads(g, g0)
        out[chunk] = {"loss_rel_diff": abs(loss - loss0) / abs(loss0),
                      "grad_rel_err": r["grad_rel_err"],
                      "worst_leaves": r["leaves"][:4]}
    xl._CHUNK = base
    print(json.dumps({"arch": cs.XLSTM, "seq_len": cs.SEQ,
                      "dtype": "float32", "base_chunk": base,
                      "against_base": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
