"""Analytic step-cost model for CP strategies on one NVIDIA H100 per
rank (DESIGN.md §Autotune; the port's copy of the reference's
``repro.autotune.cost_model``, with the H100's constants).

The autotuner's predicted scores are produced from *measured plan
properties* (communication volume from Eq.4/5 accounting, attention block
occupancy from the kernel's visit tables, workload imbalance from the
planner) combined with the hardware constants of :data:`HW`.  The model
has four terms per training step, mirroring the paper's Fig. 6
breakdown:

  comm   — KV exchange on the CP critical path (AllGather+ReduceScatter or
           ring hops); ring overlaps with compute (credited up to the
           blockwise attention time), matching Ring-Attn's design.
  attn   — attention kernel time: visited-block tensor-core work at the
           roofline, *including masked waste inside partial blocks*, plus
           a per-shard kernel-launch overhead (short shards hurt —
           Fig. 3).
  other  — data-copy overhead: per-shard fixed cost + bytes moved
           (Per-Doc's many small copies — §4.3 "Others").
  linear — QKV/O + FFN GEMMs; identical across methods (equal tokens) but
           kept so relative speedups are end-to-end, not attention-only.

The terms are those of one transformer layer (:class:`ModelDims` has no
depth, as in the reference): a step of an L-layer model costs about L
times the estimate, which ranks candidates the same.  Every function
takes the constants as ``hw=`` (default :data:`HW`), so the same
arithmetic runs against any card's figures.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.workload import plan_comm_bytes
from repro_torch.planner import ShardingPlan

#: The H100's constants, each as measured on an NVIDIA H100 80GB HBM3 at
#: a 700.00 W power limit (three significant digits; PERF.md §5 has the
#: table and the run each comes from), by the ``chip_smoke.py`` function
#: named beside it (its ``cost_model`` phase), or for ``ici_bw`` by
#: ``scripts/nccl_allgather_bw.py`` on four such cards.
HW = {
    # bf16 torch.matmul at the main path's MLP shape, 8192 x 3072 x 12288:
    # 782 TFLOP/s (chip_smoke.py:calibrate_peak_flops)
    "peak_flops": 7.82e14,
    # a 1 GiB device-to-device copy, bytes read + written: 3.02 TB/s
    # (chip_smoke.py:calibrate_hbm_bw)
    "hbm_bw": 3.02e12,
    # the CP exchange's link: NVLink through NCCL, a rank's send rate in
    # a 4-rank all-gather of 256 MiB pieces, 306 GB/s
    # (scripts/nccl_allgather_bw.py)
    "ici_bw": 3.06e11,
    # one flash_fwd call over a single visited 128 x 128 tile, 51.3 us
    # (chip_smoke.py:calibrate_kernel_overhead)
    "kernel_overhead_s": 5.13e-5,
    # one shard copy into the CP island's Eq.-5 buffer (_take_tokens of
    # 128 tokens), 24.9 us (chip_smoke.py:calibrate_copy_overhead)
    "copy_overhead_s": 2.49e-5,
    # per wasted (padded / masked no-op) kernel grid step: the control
    # cost of stepping the schedule without useful tensor-core work —
    # what the rect grid pays over the flat work queue: bf16 flash_fwd
    # rect minus flat over their step counts' difference, 62.6 ns
    # (chip_smoke.py:calibrate_grid_step)
    "grid_step_overhead_s": 6.26e-8,
}

BLOCK = 128                      # the doc kernels' attention tile


@dataclasses.dataclass
class ModelDims:
    num_heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    d_model: int = 0             # 0 -> heads * head_dim
    d_ff: int = 0                # 0 -> 4x d_model

    def __post_init__(self):
        if self.d_model == 0:
            self.d_model = self.num_heads * self.head_dim
        if self.d_ff == 0:
            self.d_ff = 4 * self.d_model


#: Half-saturation length of the flash-attention kernel's achieved share
#: of its bound — the paper's Fig. 3 effect: short shards starve the
#: kernel.  eff(L) = L / (L + L_HALF), fitted to bf16 ``flash_fwd``'s
#: share of ``peak_flops`` on one document of 512, 2048 and 8192 tokens
#: (3.3%, 12.6%, 16.7%) on an NVIDIA H100 80GB HBM3 at 700.00 W
#: (chip_smoke.py:calibrate_l_half).  It is large because the kernel
#: reaches a sixth of the matmul rate even on long documents.
L_HALF = 34300.0


def _kernel_eff(extent: int) -> float:
    return extent / (extent + L_HALF)


def _attention_block_work(plan: ShardingPlan, *, ring: bool = False
                          ) -> tuple[float, int]:
    """(effective block pairs = visited tiles incl. masked waste, divided
    by the per-kernel efficiency, shard count) for the busiest worker.

    Collective strategies run one kernel per shard over its full KV run
    (extent = prefix + length); ring processes each shard blockwise per
    rotation hop, so the kernel extent collapses to the shard length —
    the paper's Ring-Attn kernel-efficiency penalty.

    Vectorized over the plan's ShardArrays: one pass of numpy ops instead
    of a Python loop over every shard of every worker."""
    a = plan.arrays
    if len(a) == 0:
        return 0.0, 0
    # kv tiles visited by each shard's q tiles: ceil sizes to BLOCK
    q_tiles = -(-a.length // BLOCK)
    kv_len = a.start + a.length
    kv_tiles = -(-kv_len // BLOCK)
    # causal-doc structure: roughly half the q x kv tile rectangle above
    # the diagonal is skipped for the local triangle
    tri = q_tiles * (q_tiles + 1) / 2.0
    rect = q_tiles * np.maximum(kv_tiles - q_tiles, 0)
    extent = a.length if ring else kv_len
    pairs = (tri + rect) * BLOCK * BLOCK / _kernel_eff(extent)
    per_worker = np.bincount(a.worker, weights=pairs,
                             minlength=plan.num_workers)
    shards_per_worker = np.bincount(a.worker, minlength=plan.num_workers)
    return float(per_worker.max()), int(shards_per_worker.max())


def tile_flops(visited_tiles: float, dims: "ModelDims") -> float:
    """Tensor-core flops of ``visited_tiles`` BLOCK x BLOCK attention tiles (qk +
    pv matmuls, all heads) — the unit both the autotuner's predicted and
    measured table-path attention terms are denominated in."""
    return visited_tiles * BLOCK * BLOCK * 2 * dims.head_dim \
        * dims.num_heads * 2


def visited_tile_counts(plan: ShardingPlan) -> dict[str, np.ndarray]:
    """Per-worker raw tile occupancy of a plan's causal visit structure.

    Returns ``visited`` (tri+rect visited BLOCK×BLOCK tiles, no
    efficiency scaling), ``q_tiles`` (total q tiles) and ``kv_tiles_max``
    (widest per-shard KV extent in tiles) — the pieces the autotuner's
    rect-vs-flat grid term needs: a rectangular schedule steps
    ``q_tiles * kv_tiles_max`` per worker while the flat work queue steps
    only the visited count (DESIGN.md §Autotune).
    """
    N = plan.num_workers
    a = plan.arrays
    if len(a) == 0:
        z = np.zeros(N)
        return {"visited": z, "q_tiles": z.copy(), "kv_tiles_max": z.copy()}
    q_tiles = -(-a.length // BLOCK)
    kv_tiles = -(-(a.start + a.length) // BLOCK)
    tri = q_tiles * (q_tiles + 1) / 2.0
    rect = q_tiles * np.maximum(kv_tiles - q_tiles, 0)
    visited = np.bincount(a.worker, weights=tri + rect, minlength=N)
    qt = np.bincount(a.worker, weights=q_tiles, minlength=N)
    kv_max = np.zeros(N)
    np.maximum.at(kv_max, a.worker, kv_tiles.astype(np.float64))
    return {"visited": visited, "q_tiles": qt, "kv_tiles_max": kv_max}


def step_breakdown(plan: ShardingPlan, dims: ModelDims,
                   *, train: bool = True, hw: dict = HW,
                   dtype_bytes: int = 2) -> dict:
    """Four-term analytic step cost of one plan (see module docstring).

    ``dtype_bytes`` sets the KV wire dtype (2 = bf16 native, 1 = the
    int8-quantized exchange) — the autotuner sweeps it; every seed
    benchmark keeps the default.
    """
    N = plan.num_workers
    C = plan.context_len
    tokens_per_worker = C // N
    fb = 3.0 if train else 1.0        # fwd + bwd(2x) GEMM factor

    # ---- attention ------------------------------------------------- #
    ring = plan.comm_style == "ring"
    pairs, n_shards = _attention_block_work(plan, ring=ring)
    attn_flops = pairs * 2 * dims.head_dim * dims.num_heads * 2  # qk + pv
    kernel_launches = n_shards * (N if ring else 1)
    attn_s = fb * attn_flops / hw["peak_flops"] \
        + kernel_launches * hw["kernel_overhead_s"]

    # ---- communication ----------------------------------------------- #
    comm_bytes = plan_comm_bytes(plan, dims.kv_heads, dims.head_dim,
                                 dtype_bytes=dtype_bytes, fwd_and_bwd=train)
    comm_s = comm_bytes / hw["ici_bw"]
    if plan.comm_style == "ring":
        # ring overlaps each hop with blockwise compute; only the
        # non-overlapped remainder is exposed, plus LSE-merge passes
        merge_s = (N - 1) * tokens_per_worker * dims.num_heads \
            * dims.head_dim * 4 * 2 / hw["hbm_bw"]
        comm_s = max(0.0, comm_s - attn_s) + merge_s

    # ---- data copies (§4.3 "Others") ---------------------------------- #
    copy_bytes = int(plan.arrays.length.sum()) / N * dims.kv_heads \
        * dims.head_dim * 2 * 2
    other_s = len(plan.arrays) / N * hw["copy_overhead_s"] \
        + copy_bytes / hw["hbm_bw"]

    # ---- token-linear GEMMs (equal across methods) -------------------- #
    d = dims.d_model
    lin_flops = tokens_per_worker * (
        2 * d * (dims.num_heads + 2 * dims.kv_heads) * dims.head_dim
        + 2 * dims.num_heads * dims.head_dim * d
        + 2 * 3 * d * dims.d_ff)
    linear_s = fb * lin_flops / hw["peak_flops"]

    total = attn_s + comm_s + other_s + linear_s
    return {"attn_s": attn_s, "comm_s": comm_s, "other_s": other_s,
            "linear_s": linear_s, "total_s": total,
            "comm_bytes": comm_bytes, "shards": len(plan.arrays),
            "imbalance": plan.imbalance_ratio()}
