#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Builds the hand-written CUDA kernels from the sources in this checkout
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version on the card (f32 and bf16; the split-KV decode kernels
also against their split twins), and times it beside its bound, its
plain version and a library call, with its achieved GB/s, TFLOP/s and
share of the bound.  Then it drives the port's
two paths end to end at the full width of starcoder2_3b (30 layers,
d_model 3072, random weights from a seed), each with every kernel's
launch count set to 0 just before and read just after:

* serving: 12 requests on 6 slots through the paged layout
  (``flash_decode_paged``) and the dense layout (``flash_decode`` in
  partial mode), both split-KV, gated on every request ending ok
  and on the launch counts; one decode step flash vs the dense oracle;
  one profiled decode step of each layout; a small f32 model served on
  the card and on the CPU must give the same tokens, and the same on
  the paged and the dense layout;
* training: 4 steps on one 8192-token wlb_llm batch (``flash_fwd``,
  ``flash_bwd_dq``, ``flash_bwd_dkv`` on the flat work queue), gated on
  finite losses and on 30 x (2, 1, 1) launches per step; one step with
  the kernels vs the plain attention from the same parameters and batch;
  and a small f32 model trained 3 steps on the card and on the CPU (the
  kernels' twins) must agree;
* the step audit: one more main-path step at full width through the
  three kernels under ``analysis.step_audit`` (exactly one
  ``train_step`` call): no f64 and no host-sync site outside the
  module's ``cuda`` list, the sites on a line of their own
  (``step_audit``);
* the tooling: the cost model's constants
  (``repro_torch.autotune.cost_model.HW``, ``L_HALF``) measured on the
  card beside the package's, ``peak_flops`` and ``hbm_bw`` gated within
  2x, and the bf16 rect grid's kernel times (``cost_model``);
  ``train.py --autotune`` at full width: the pick trained 2 steps
  through the doc kernels (launches gated), a second call a cache hit,
  dry picks at 1x4 and 2x2 that spawn nothing, and the cost model's
  step beside the card's (``autotune``); and the verifier on the card's
  own artifacts: the TAB/WQ rules on every training step's tables
  (``train``), the SRV rules on both serving engines (``main_path``),
  WIRE101-103 on every native CP island (``cp_islands``);
* the examples (``examples/*_torch.py``), each through its ``main``:
  plan_explorer and quickstart's plans on the host, quickstart's tiny
  training through the doc kernels (the loss falls, launches gated),
  serve_decode on the paged layout (every request ok, launches gated),
  and train_lm: lm_124m (12 layers, d 768, f32) trained its 300 steps
  through the f32 doc kernels and again through the plain attention from
  the same parameters (step 0 and the last 20 steps' mean loss gated,
  the loss falls by a nat, launches gated), then resumed from its
  step-300 checkpoint for 20 steps against an in-process continuation
  (``examples``);
* context parallelism, on one 32768-token wlb_llm sequence: the doc
  kernels at a CP hop's shape (``doc_hop_shapes``, with the kernel
  parity); the CP islands at N = 4 (flashcp chunked and monolithic,
  llama3, ring_zigzag) and N = 2 (flashcp), f32 and bf16, each rank's
  outputs and gradients against the one-rank path, and the same on the
  int8 KV wire (flashcp chunked and monolithic, llama3 at N = 4, flashcp
  chunked at N = 2) within the reference's int8 bounds of the one-rank
  path and with the native wire's launches, the K/V bytes each rank
  hands to its ``CPComm`` beside the Eq. 5 figure (``cp_islands``); and
  4 CP ranks (a 1x4 mesh, ZeRO-3) training full-width starcoder2_3b cut
  to 2 layers for 2 steps, step 0 against one rank (``cp_train``); in
  the same job of the same 4 ranks, the two-pod layout: a 2x1x2 (pod,
  data, model) mesh, rows over ``pod``, tokens over ``model``, ZeRO-3
  over all three axes, one step of the same model on 2 rows of 16384
  tokens, step 0 against one rank and every rank's shards exact
  (``pod_train``); and the per-rank dry run (``launch.dryrun``) traced
  on the host, three cells at once on the rank pool's workers while the
  card runs ``moe_serve`` and ``moe_train``: the main path's
  cell, whose predicted peak must lie within 2x of the train phase's
  measured one, pod_train's, whose predicted ZeRO-3 state must be what
  each rank holds, and one production cell (starcoder2_3b x train_4k on
  2x16x16) with its ``fits`` (``dryrun``);
* the distributed training loop: a 2x2 mesh (rows over ``data``, tokens
  over ``model``, parameters and optimizer state sharded over both)
  training the same model cut to 2 layers on 2 rows of 16384 tokens for
  2 steps against one rank, then the f32 smoke model checkpointed on 2x2 and
  resumed on 1x4 (``dp_train``); and all 30 layers on a 2x1 mesh for one
  step against one rank (``dp_full``).  Every rank checks that it holds
  exactly its ZeRO-3 shards.  The ranks of every such phase run on one
  pool of 4 worker processes started after the build (each phase's
  ranks join their own process group); where they share a card they
  use gloo, whose exchange goes through host memory, else NCCL with one
  rank per card;
* the rest of serving: the main path's paged run again under chaos (a
  request poisoned in its decode, one at its final prefill chunk, one
  stuck, a latency spike, and a kill restored from a snapshot into a
  fresh engine), gated on every request ending, exactly the faulty ones
  aborted with their reasons, the healthy ones with the clean run's
  tokens and no poisoned block in the prefix trie
  (``serve_resilience``); the dense layout at ``attn_shards`` 2 and 4:
  one bf16 decode step's logits within a rounding of one shard's, and
  in f32 tokens equal to one shard's and ``flash_decode`` launched
  steps x 30 x shards times (``serve_sharded``); then, in the spawn of
  ``cp_islands``, the main path's dense cache (layer 0) split along S
  over 2 and over 4 ranks joined through env://, each rank one
  ``flash_decode`` partial a step on its slice, merged over the ranks
  (``merge_partials_axis``), against one rank's normalized
  ``flash_decode`` in f32 and bf16 (``serve_sharded_ranks``);
* the MoE family, olmoe_1b_7b at full width (64 experts, top-8): served
  at full depth (16 layers) on both layouts, launch counts, one f32
  decode step flash vs dense oracle, and a small f32 MoE model card vs
  CPU (``moe_serve``); trained with depth cut to 4 layers on one
  8192-token sequence, launch counts and the step through the kernels
  vs the plain attention (``moe_train``); and on a 1x4 mesh with the
  experts split over ``model`` and the expert-parallel all-to-all
  island: a drop-free f32 step 0 against one rank, leaf by leaf, then
  the model's own capacity for 2 steps on 32768 tokens
  (``moe_cp_train``).  The routed pairs the capacity drops are counted;
* the recurrent families: jamba_v0_1_52b at full width cut to one period
  (8 layers: 7 Mamba, 1 attention at Hq 32 / Hkv 8, 4 MoE; 13.30 B
  parameters) serving 6 requests of 48-96 tokens on 6 slots, each prompt
  replayed through the decode step: every request ok, ``flash_decode``
  launched (replay + decode steps) x 1 times, the kernel against its
  plain version at 32 / 8 heads, and in f32 the replayed logits against
  the training forward (``jamba_serve``); a full-width Mamba sublayer
  (forward and backward, bf16 and f32 against a sequential f32
  recurrence, the selective scan's share of its time), an attention
  sublayer through the three doc kernels against the plain attention
  (``jamba_layers``); the smoke jamba trained on the card and on the CPU
  (``jamba_smoke``); xlstm_350m at full width and depth trained 3 steps
  on 8192 tokens with no kernel launched (``xlstm_train``); in one spawn
  of 4 ranks, the selective-scan island on 32768 tokens and 1x4
  ``contiguous`` steps 0 of both models, each against one rank
  (``rec_cp``); xlstm_350m served the jamba load, a small f32 xLSTM card
  vs CPU (``xlstm_serve``);
* the audio and VLM frontends: all five kernels at musicgen_medium's
  heads (24 over 24 KV heads, D 64: GQA group 1) and internvl2_1b's (14
  over 2, D 64: group 7) against their plain versions in f32 and bf16,
  timed beside their bounds, plain versions and SDPA
  (``frontend_kernels``); each model at full width and depth (48 and 24
  layers) trained 3 steps on one 8192-token sequence through
  ``build_train_step`` with its frame or patch embeddings drawn from the
  seed in plan order (finite losses, layers x (2, 1, 1) launches a
  step), and serving the main path's 12 requests on both layouts, the
  audio prompts with their own frames (launches, paged vs dense tokens,
  a smoke f32 model card vs CPU);
* adaptive dispatch and elastic recovery: starcoder2_3b at full width
  cut to 1 layer on a 2x2 mesh of ranks sharing the card, 4 rows of
  4096 tokens a step, whose CP degree changes between steps (each
  switch reshards the ZeRO-3 state): its losses against one rank's
  run of the same stream, its doc-kernel launches per rank those of
  its degrees; the same run losing host 1 (ranks 2 and 3) at step 3,
  shrunk to 1x2 with 2 micro-batches a step from the step-3 checkpoint,
  and (on one rank) restarted at step 3, each against the same losses;
  and with host 1 twice as slow, every rank making rank 0's placements
  (``dispatch``).

Run from the repository root:

    python3 chip_smoke.py            # everything (one GPU)
    python3 chip_smoke.py --quick    # build + parity of all five kernels
                                     # (and the doc kernels at a hop shape)

Prints one JSON line per phase (and each phase's wall time as a
``phase_seconds`` line), the card's name and power limit, the
kernel table, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when a phase fails or there is no
CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
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
DOC_SOURCE = "src/repro_torch/kernels/csrc/doc_attention.cu"
# Pallas TPU kernels replaced (function definition lines)
REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:156",
            "flash_decode_paged": "src/repro/kernels/flash_decode.py:282",
            "flash_fwd": "src/repro/kernels/doc_attention.py:634",
            "flash_bwd_dq": "src/repro/kernels/doc_attention.py:802",
            "flash_bwd_dkv": "src/repro/kernels/doc_attention.py:967"}
DOC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# kernel-parity shapes: full-width starcoder2_3b heads, the serving batch
B, HQ, HKV, D = 6, 24, 2, 128
S_DENSE, BLOCK = 1056, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# one bf16 decode step of the full model against another route to the
# same logits (flash vs the dense oracle; 2 or 4 LSE-merged segments vs
# one), relative to the largest logit: a rounding of the attention
# output, where a segment lost or merged wrong moves logits by O(1)
DECODE_STEP_BF16_TOL = 2e-2
# the dense split kernel's partial m (absolute) and l (relative) against
# its split twin in either dtype: f32 statistics of the same scores
STAT_TOL = 1e-5

# training: full-width starcoder2_3b heads on one 8192-token batch
ARCH, SEQ, STEPS = "starcoder2_3b", 8192, 4
T_HQ, T_HKV, T_D, T_BLOCK = 24, 2, 128, 128
# doc kernels vs twins: f32 isolates the algorithm (same products, other
# order, softmax rescaled per 32-key sub-tile); bf16 adds the rounding of
# the outputs and of p / dS.  Gradients are held relative to their
# largest entry.
DOC_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the bf16 dK/dV rounds only its outputs (Pᵀ and dSᵀ enter its products as
# hi + lo bf16 pairs), so it has its own, tighter bound
DKV_BF16_TOL = 1e-2
# matrix products per visited (q block, kv block) pair and head
MATMULS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
# full-width flash vs plain step (bf16): relative bounds on loss and
# grad norm
STEP_LOSS_TOL, STEP_GNORM_TOL = 5e-3, 5e-2
# f32 smoke model, 3 steps, card kernels vs CPU twins
SMOKE_TRAIN_TOL = 1e-4

# the cost model's constants (repro_torch.autotune.cost_model.HW), measured
# on the card: a bf16 matmul at the main path's MLP shape (M x K x N), a
# 1 GiB device-to-device copy, flash_fwd on one document of these lengths
# (one 128 x 128 tile for the launch overhead; the rest for L_HALF), the
# rect grid against the flat one on the main path's step-0 tables; each
# a median of CAL_REPS.  The package's peak_flops and hbm_bw must lie
# within CAL_RATIO of what the card gives (a constant of another chip
# left behind fails); the overheads and L_HALF are printed, not gated.
CAL_MATMUL, CAL_COPY_BYTES, CAL_REPS = (8192, 3072, 12288), 1 << 30, 20
CAL_ONE_TILE, CAL_DOC_LENS, CAL_RATIO = 128, (512, 2048, 8192), 2.0
# train.py --autotune: the main path's model and sequence, AUTOTUNE_STEPS
# steps with the pick; then dry runs at the meshes of cp_train and
# dp_train, which must spawn nothing
AUTOTUNE_STEPS = 2

# context parallelism: full-width starcoder2_3b attention on one
# 32768-token wlb_llm sequence.  The island and hop checks take the batch
# of pipeline step 6, whose Eq.-5 bucket at N = 4 (4096) is half of
# t_loc (8192), so a hop's keys are not shaped like its queries (at
# steps 0 and 1 one rank's tokens are all non-last and the bucket is the
# whole t_loc).
CP_SEQ, CP_STEP = 32768, 6
CP_ISLANDS = ((4, "flashcp", "chunked"), (4, "flashcp", "none"),
              (4, "llama3", "chunked"), (4, "ring_zigzag", "chunked"),
              (2, "flashcp", "chunked"))
# the same islands on the int8 KV wire (RunConfig.kv_comm_dtype)
CP_INT8 = ((4, "flashcp", "chunked"), (4, "flashcp", "none"),
           (4, "llama3", "chunked"), (2, "flashcp", "chunked"))
# islands vs the one-rank path, relative to the largest entry: the same
# kernels over other KV subsets, merged by online LSE in another order
CP_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the int8 wire vs the one-rank path, relative to the largest entry, in
# both dtypes: the reference's own int8 bounds (output, gradients;
# tests/multidevice/cp_check.py)
CP_INT8_TOL = {"o": 3e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
# CP training: depth cut to 2 layers (4 until the script needed the time:
# the ranks spend it moving the ZeRO-3 state through host memory), 2
# steps (3 until the script ran past 1200 s on a slow host); step 0's
# loss and grad norm vs the one-rank step, relative.  At 1 layer the
# embedding's gradient (F2 below) is a larger share of the norm, which
# then moves by 1.5e-2 (chip run, H100 80GB HBM3, 700.00 W)
CP_TRAIN_WORLD, CP_TRAIN_LAYERS, CP_TRAIN_STEPS = 4, 2, 2
CP_TRAIN_TOL = 1e-2
# ... and every step-0 gradient leaf within CP_TRAIN_TOL (relative norm of
# the difference) but the embedding table's: its backward scatter-adds
# each token's row gradient into a bf16 table, one rounding per add, so a
# frequent token's row stops growing once it is large, and one rank (4x
# the adds per row of a CP rank) loses more.  Printed, not gated; in f32
# every leaf, this one too, agrees (test_cp_train_step_matches_jax on the
# CPU).
EMBED_LEAF = "embed/e"
F2 = ("not a fault of the port: the reference rounds the same way on the "
      "CPU (tests/test_torch_zero.py::test_bf16_embedding_grad_matches_"
      "reference_bit_for_bit); what its TPU does is not known")
# the distributed loop: a 2x2 mesh (4 ranks) training full-width
# starcoder2_3b cut to 2 layers (4 until the dispatch phase needed the
# time; 2 layers as cp_train) on 2 rows of 16384 tokens (8192 per rank),
# 2 steps (3 until the script ran past 1200 s on a slow host), against
# one rank on the same global batch; step 0's loss relative, grad norm
# and every leaf but the embedding table's as in cp_train
DP_MESH, DP_LAYERS, DP_SEQ, DP_BATCH, DP_STEPS = (2, 2), 2, 16384, 2, 2
DP_LOSS_TOL, DP_TOL = 1e-4, 1e-2
# the two-pod layout, on the 4 ranks of cp_train's job: a 2x1x2 (pod,
# data, model) mesh training dp_train's model and batch (2 layers, 2 rows
# of 16384 tokens: a row per pod, its tokens over model) for one step,
# ZeRO-3 over all three axes; step 0 against dp_train's one-rank step
# within cp_train's bounds
POD_MESH = (2, 1, 2)
# the dry run on the host (launch/dryrun.py): the main path's cell (1x1,
# one SEQ-token sequence) must predict the train phase's measured peak
# within this factor (the looseness of the cost model's constants), with
# the kernel-adjusted peak (the doc kernels keep the scores on chip);
# pod_train's cell must predict each rank's ZeRO-3 state bytes exactly
DRYRUN_PEAK_RATIO = 2.0
# one production cell, printed with its fits: (arch, shape, multi_pod)
DRYRUN_PROD = ("starcoder2_3b", "train_4k", True)
# the smoke model (f32, on the card): a checkpoint written at step 2 on
# 2x2 and resumed on 1x4 against the uninterrupted 4-step run
DP_RESUME_AT, DP_RESUME_STEPS, DP_RESUME_TOL = 2, 4, 1e-5
# the 2x2 run's final checkpoint (full width, 2 layers) restored on the
# same mesh: each rank's shards bit for bit, and the device's peak over
# the restore within this many bytes of the rank's state (the allocator's
# rounding; the whole state is 4x it)
DP_RESTORE_SLACK = 16 << 20
# all 30 layers (3.18 B parameters) on a 2x1 mesh, one step of 2 rows of
# 8192 tokens, against one rank
DP_FULL_MESH, DP_FULL_SEQ, DP_FULL_BATCH = (2, 1), 8192, 2
# a rank group that outlives this is killed and the phase fails
RANK_TIMEOUT = 300
# the rank phases run on one pool of this many worker processes, started
# once (a spawn per phase paid 10-25 s before any work)
RANK_POOL = 4
# serving under chaos (full-width starcoder2_3b, paged, the main path's
# requests): planned steps without progress before the watchdog aborts a
# stuck slot, the latency spike, and the snapshot period of the killed run
RES_PATIENCE, RES_DELAY_STEP, RES_DELAY_S = 8, 3, 0.25
RES_SNAPSHOT_EVERY = 20
# sharded dense decode: segments per stripe, and ranks the cache's S is
# split over (flash_decode_ranks); the f32 runs at each segment count
# generate SHARD_GEN tokens a request
SHARDS = (2, 4)
SHARD_GEN = 32
# the MoE family: olmoe_1b_7b at full width (d 2048, 16 heads of 128, 64
# experts of d_ff 1024, top-8, vocab 50304).  Training cuts depth to 4
# layers (16 layers of bf16 weights and gradients, fp32 master, mu and nu
# are 111 GB); serving runs all 16 and decodes MOE_GEN tokens a request
# (its decode steps are host-bound: 32 tokens took ~12 s of the phase).
MOE_ARCH = "olmoe_1b_7b"
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_GEN = 4, 3, 8
# one f32 decode step of the full model, flash vs the dense oracle,
# relative to the largest logit (in bf16 a rounding difference can flip a
# token's top-8 experts, which moves its logits by far more; printed)
MOE_DECODE_TOL = 1e-3
# MoE over 4 EP/CP ranks (1x4, ZeRO-3, experts split over model): (a) the
# gate at 1 layer, f32, at the drop-free capacity factor E / top_k on
# one 8192-token sequence, step 0 against one rank, loss and every
# gradient leaf; (b) the model's own capacity factor at 1 layer on one
# 32768-token sequence, 2 steps (both at 2 layers, (b) at 4 before, until
# the script ran past 1200 s on a slow host: a layer's 64 experts are
# 2x its embedding's state, moved through host memory)
MOE_CP_WORLD, MOE_GATE_LAYERS, MOE_CP_GATE_TOL = 4, 1, 1e-3
MOE_DROP_FREE = {"capacity_factor": 8.0}
MOE_CP_LAYERS, MOE_CP_STEPS = 1, 2
# the recurrent families.  jamba_v0_1_52b at full width (d 4096, 32 heads
# of 128 over 8 KV heads, d_inner 8192, d_state 16, 16 experts top-2) cut
# to one period of 8 layers (7 Mamba + 1 attention, 4 MoE; 13.30 B
# parameters, 26.6 GB in bf16): its training state (>= 186 GB at 14 bytes
# a parameter) fits no card, so it trains end to end at smoke width and at
# full width sublayer by sublayer.  xlstm_350m (24 layers, no attention)
# trains and serves at full width and depth.
JAMBA, XLSTM, JAMBA_PERIOD = "jamba_v0_1_52b", "xlstm_350m", 8
# serving load of both: 6 requests of 48-96 tokens on 6 slots, 16 tokens
REC_REQUESTS, REC_LO, REC_HI, REC_GEN, REC_SLOTS = 6, 48, 96, 16, 6
# replayed last-token logits vs the training forward (f32, drop-free),
# relative to the largest logit: the reference's decode-vs-forward bound
REPLAY_TOL = 1e-4
# a Mamba sublayer vs a sequential f32 recurrence, relative to the largest
# output: in f32 the chunked doubling scan associates the same sums in
# another order; bf16 adds the rounding of the projections and of y
MAMBA_SEQ_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the selective-scan island at N = 4 on one 32768-token sequence, and the
# 1x4 steps of the smoke jamba and of xlstm_350m, f32, against one rank,
# relative to each array's largest entry (leaves: relative norm)
SCAN_WORLD, SCAN_SEQ, REC_SMOKE_WORLD, REC_CP_TOL = 4, 32768, 4, 1e-4
# ... but xlstm_350m's full-width f32 gradients move by more than that
# when only the order of their sums changes: on one rank, the mLSTM's
# chunk of 64 against 32 / 128 moves the whole gradient by 1.6e-3 /
# 2.3e-3 and its worst leaf by 2.9e-3 / 8.1e-3, the loss by 8.4e-8 / 0
# (scripts/xlstm_chunk_spread.py, H100 80GB HBM3, 700.00 W), and each CP
# rank chunks its own tokens; so its leaves are held at 2.5x that spread
# (its loss still at REC_CP_TOL)
XLSTM_CP_LEAF_TOL = 2e-2
REC_SMOKE_SEQ, REC_SMOKE_STEPS, XLSTM_STEPS = 1024, 3, 3
# the audio and VLM frontends at full width and depth: musicgen_medium
# (48 layers, d 1536, 24 heads over 24 KV heads of 64: GQA group 1, 1.36 B
# parameters held) and internvl2_1b (24 layers, d 896, 14 heads over 2 of
# 64: group 7, vocab 151655).  The kernels at those heads (D 64) against
# their plain versions at the main path's shapes; training FRONT_STEPS
# steps of one SEQ-token sequence; serving the main path's 12 requests
# with FRONT_GEN tokens each.
FRONT_HEADS = (("musicgen_medium", 24, 24), ("internvl2_1b", 14, 2))
FRONT_D, FRONT_STEPS, FRONT_GEN = 64, 3, 32
# adaptive dispatch and elastic recovery: full-width starcoder2_3b cut to
# DISPATCH_LAYERS layers on a 2x2 mesh of ranks sharing the card, 4 rows
# of DISPATCH_SEQ tokens a step; seed DISPATCH_SEED's stream dispatches
# at CP degrees 1, 2, 2, 2 (found on the host: the dispatcher is numpy).
# Losses of the 2x2 runs against one rank's run of the same stream,
# relative: bf16 sums in other orders over 4 optimizer steps.  The ranks
# move the ZeRO-3 state through host memory (gloo) at each step, degree
# switch, checkpoint (6.9 GB of state at 2 layers, 5.6 GB at 1) and
# restore: at 4 layers the phase took 500 s of the script's 1200 s, at 2
# layers 189-251 s over runs, so it runs at 1 layer, the restart at one
# rank, the shrink and the restart checkpoint every 2 steps (the same
# step-3 restore, one save fewer) and the straggler run 3 steps.
DISPATCH_MESH, DISPATCH_LAYERS, DISPATCH_SEQ = (2, 2), 1, 4096
DISPATCH_BATCH, DISPATCH_STEPS, DISPATCH_SEED = 4, 4, 1
DISPATCH_LOSS_TOL = 1e-2
DISPATCH_TIMEOUT = 600
# the 2x2 runs ("{ckpt}" is the run's checkpoint directory)
DISPATCH_RUNS = (
    ("dispatch", ()),
    ("shrink", ("--hosts", "2", "--fail-at", "3:1", "--checkpoint-dir",
                "{ckpt}", "--ckpt-every", "2")),
    ("straggle", ("--hosts", "2", "--straggle", "1:2.0", "--steps", "3")))
# the examples (examples/*_torch.py) on the card.  train_lm trains
# lm_124m (12 layers, d 768, 12 / 12 heads of 64, f32) for its default
# 300 steps of one 256-token pile sequence through the f32 doc kernels
# and again through the plain attention from the same parameters: the
# losses at step 0 within EX_STEP0_TOL of each other (relative; the same
# arithmetic in another order) and their means over the last EX_TAIL
# steps within EX_TAIL_TOL (300 AdamW steps let f32 rounding grow); the
# kernel run's last EX_TAIL losses at least EX_DROP nats below its
# first.  The run is then continued EX_CONT steps in process, twice from
# the same state (the spread two identical runs show), and resumed by
# the example from its step-300 checkpoint with --steps 300 + EX_CONT:
# its losses within EX_RESUME_SPREADS x the spread of the continuation's
# (equal where the step is deterministic).
EX_STEPS, EX_CONT, EX_TAIL = 300, 20, 20
EX_STEP0_TOL, EX_TAIL_TOL, EX_DROP, EX_RESUME_SPREADS = 1e-5, 1e-2, 1.0, 2


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
def dense_case(torch, dtype, gen, hq=HQ, hkv=HKV, d=D):
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, hkv, S_DENSE, d), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((B, hkv, S_DENSE, d), generator=gen,
                    device="cuda").to(dtype)
    lengths = torch.tensor([-1, 0, S_DENSE - 1, 517, 800, 1023],
                           dtype=torch.int32, device="cuda")
    return q, k, v, lengths


def paged_case(torch, dtype, gen, hq=HQ, hkv=HKV, d=D):
    """Pool of 6 * 66 + 8 blocks of 16; tables drawn from a shuffled
    pool, row 1 sharing row 0's first two blocks, table slots past each
    length left 0, and an empty row."""
    nk = S_DENSE // BLOCK
    nb = B * nk + 8
    k_pool = torch.randn((hkv, nb * BLOCK, d), generator=gen,
                         device="cuda").to(dtype)
    v_pool = torch.randn((hkv, nb * BLOCK, d), generator=gen,
                         device="cuda").to(dtype)
    lengths = [1000, 700, S_DENSE - 1, 0, 333, -1]
    perm = torch.randperm(nb, generator=gen, device="cuda").cpu().tolist()
    tables = torch.zeros((B, nk), dtype=torch.int32)
    for b, ln in enumerate(lengths):
        need = ln // BLOCK + 1 if ln >= 0 else 0
        tables[b, :need] = torch.tensor(perm[b * nk:b * nk + need])
    tables[1, :2] = tables[0, :2]
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(dtype)
    return (q, k_pool, v_pool,
            torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            tables.to("cuda"))


def paged_split(torch, tables, hkv=HKV):
    """The (pages_per_split, n_split) the paged wrapper picks here."""
    from repro_torch.kernels import flash_decode as fd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fd.paged_split_plan(B, hkv, tables.shape[1], BLOCK, sms)


def dense_split(torch, S, hkv=HKV):
    """The (pages_per_split, n_split) the dense wrapper picks here, over
    tiles of fd.DENSE_TILE positions."""
    from repro_torch.kernels import flash_decode as fd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fd.dense_split_plan(B, hkv, S, sms)


def achieved(ms: float, nbytes: int, flops: int, bms: float) -> dict:
    """A kernel time's rates and its share of the bound."""
    return {"gb_per_s": nbytes / ms / 1e6, "tflops_per_s": flops / ms / 1e9,
            "bound_share": bms / ms}


def visible_positions(lengths) -> int:
    return int(sum(max(int(x) + 1, 0) for x in lengths.tolist()))


def decode_times(torch, timer, gen, hq=HQ, hkv=HKV, d=D, *,
                 normalized: bool = True, phase: str = "kernel_time",
                 **tag) -> dict:
    """bf16 times of the decode kernels at (hq, hkv, d) on the serving
    batch (the dense kernel in partial mode, with ``normalized`` also
    normalized, and the paged kernel), each beside its bound, its plain
    version and one SDPA call; emitted as ``phase`` lines with ``tag``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd

    dt, esize = torch.bfloat16, 2
    q, k, v, ln = dense_case(torch, dt, gen, hq, hkv, d)
    qp, kp, vp, lp, tp = paged_case(torch, dt, gen, hq, hkv, d)
    kv_view = fd.gather_paged_kv(kp, tp, BLOCK), fd.gather_paged_kv(vp, tp,
                                                                    BLOCK)
    pos = torch.arange(S_DENSE, device="cuda")

    def sdpa(qq, kk, vv, lens):
        mask = (pos[None, :] <= lens[:, None].long())[:, None, None, :]
        return F.scaled_dot_product_attention(qq[:, :, None], kk, vv,
                                              attn_mask=mask,
                                              enable_gqa=True)

    cases = [
        ("flash_decode",
         lambda: fd.flash_decode(q, k, v, ln, partial=True),
         lambda: fd.decode_partial_reference(q, k, v, ln),
         lambda: sdpa(q, k, v, ln), ln, 0, B * hq * (d + 2) * 4),
        ("flash_decode_normalized",
         lambda: fd.flash_decode(q, k, v, ln),
         lambda: fd.decode_reference(q, k, v, ln),
         lambda: sdpa(q, k, v, ln), ln, 0, B * hq * d * esize),
        ("flash_decode_paged",
         lambda: fd.flash_decode_paged(qp, kp, vp, lp, tp,
                                       block_size=BLOCK),
         lambda: fd.paged_decode_reference(qp, kp, vp, lp, tp,
                                           block_size=BLOCK),
         lambda: sdpa(qp, *kv_view, lp), lp, tp.numel() * 4,
         B * hq * d * esize)]
    times = {}
    for name, call, plain, lib, lens, extra_in, out_b in cases:
        if name == "flash_decode_normalized" and not normalized:
            continue
        vis = visible_positions(lens)
        read = (B * hq * d + 2 * vis * hkv * d) * esize + B * 4 + extra_in
        flops = 4 * vis * hq * d
        bms, by = bound_ms(read, out_b, flops, "bfloat16")
        ms = timer(call)
        times[name] = {"ms": ms, "plain_ms": timer(plain),
                       "library_ms": timer(lib), "bound_ms": bms,
                       "bound_by": by, "bytes": read + out_b,
                       **achieved(ms, read + out_b, flops, bms)}
        emit(phase, **tag, name=name, dtype="bfloat16", **times[name])
    return times


def kernel_phase(torch, timer, quick: bool) -> dict:
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
        # the dense split kernel against its split twin, both modes
        dpps, d_split = dense_split(torch, S_DENSE)
        tw = fd.decode_split_plain(q, k, v, ln, tile=fd.DENSE_TILE,
                                   pages_per_split=dpps, partial=True)
        tw_norm = finalize_partial(tw, dtype)
        e_dtwin = max(
            (out.float() - tw_norm.float()).abs().max().item(),
            (finalize_partial((o, m, l), torch.float32)
             - finalize_partial(tw, torch.float32)).abs().max().item())
        e_dtwin_m = (m - tw[1]).abs().max().item()
        e_dtwin_l = ((l[1:] - tw[2][1:]).abs() / tw[2][1:]).max().item()
        qp, kp, vp, lp, tp = paged_case(torch, dtype, gen)
        outp = fd.flash_decode_paged(qp, kp, vp, lp, tp, block_size=BLOCK)
        torch.cuda.synchronize()
        refp = fd.paged_decode_reference(qp, kp, vp, lp, tp,
                                         block_size=BLOCK)
        pps, n_split = paged_split(torch, tp)
        twin = fd.paged_decode_split_plain(qp, kp, vp, lp, tp,
                                           block_size=BLOCK,
                                           pages_per_split=pps)
        e_paged = (outp.float() - refp.float()).abs().max().item()
        e_twin = (outp.float() - twin.float()).abs().max().item()
        paged_empty_ok = bool((outp[B - 1] == 0).all())   # length -1
        emit("kernel_parity", dtype=name, tol=tol,
             flash_decode_err=e_norm, flash_decode_partial_err=e_part,
             partial_m_err=e_m, partial_l_rel_err=e_l,
             flash_decode_vs_split_twin_err=e_dtwin,
             split_twin_m_err=e_dtwin_m, split_twin_l_rel_err=e_dtwin_l,
             stat_tol=STAT_TOL,
             dense_tile=fd.DENSE_TILE, dense_pages_per_split=dpps,
             dense_splits=d_split,
             flash_decode_paged_err=e_paged,
             flash_decode_paged_vs_split_twin_err=e_twin,
             paged_pages_per_split=pps, paged_splits=n_split,
             empty_row_exact=empty_ok, paged_empty_row_exact=paged_empty_ok)
        if max(e_norm, e_part, e_paged, e_twin, e_dtwin) > tol \
                or not empty_ok or not paged_empty_ok or e_m > tol \
                or e_l > max(tol, 1e-5) or e_dtwin_m > STAT_TOL \
                or e_dtwin_l > STAT_TOL:
            raise AssertionError(f"kernel parity failed in {name}")
        err["flash_decode"] = max(err["flash_decode"], e_norm, e_part,
                                  e_dtwin)
        err["flash_decode_paged"] = max(err["flash_decode_paged"], e_paged,
                                        e_twin)
    if quick:
        return {"err": err}

    # times at the same shapes in the model dtype (bf16)
    return {"err": err, "times": decode_times(torch, timer, gen)}


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


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name; each counts its own
    launches in ``.launches``."""
    from repro_torch.kernels import doc_attention as da
    from repro_torch.kernels import flash_decode as fd
    return {"flash_decode": fd.flash_decode,
            "flash_decode_paged": fd.flash_decode_paged,
            "flash_fwd": da.flash_fwd, "flash_bwd_dq": da.flash_bwd_dq,
            "flash_bwd_dkv": da.flash_bwd_dkv}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {n: fn.launches for n, fn in kernel_counters().items()}


def serve_run(torch, cfg, params, layout, prompts, gen, device="cuda",
              frames=None, **kw):
    from repro_torch.serve import ServeEngine

    max_len = max(len(p) for p in prompts) + gen
    eng = ServeEngine(cfg, params, device=device, kv_layout=layout,
                      max_len=max_len, prefix_cache=True, **kw)
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=gen,
                   frames=None if frames is None else frames[i])
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    bad = {r: e["status"] for r, e in results.items() if e["status"] != "ok"}
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"{layout}: requests not ok: {bad}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return eng, results, launches, wall, peak


def serve_state_gate(eng, what: str) -> None:
    """The verifier's SRV rules on an engine whose requests have ended
    (``check_serve_state``: every block's refcount is its table uses plus
    the prefix cache's and the spares' references, the free list holds
    exactly the refcount-0 blocks, no block is shared without a prefix
    entry); raises on an error finding.  The dense layout's stripes have
    no pool: the check confirms it holds no block state."""
    from repro_torch.analysis import errors, format_findings
    from repro_torch.analysis.plan_check import check_serve_state

    tables, extra = eng.block_tables()
    if eng.pool is None:
        emit("serve_state_check", engine=what, layout=eng.layout,
             pool=None, live_tables=len(tables), findings=[])
        if tables or extra or eng.prefix is not None:
            raise AssertionError(f"{what}: a dense engine holds blocks")
        return
    fs = check_serve_state(eng.pool, tables, eng.prefix, extra_refs=extra,
                           context=what)
    emit("serve_state_check", engine=what, layout=eng.layout,
         blocks=eng.pool.num_blocks, free=eng.pool.free_count,
         prefix_nodes=0 if eng.prefix is None else len(eng.prefix),
         live_tables=len(tables), findings=[f.render() for f in fs])
    if errors(fs):
        raise AssertionError(format_findings(fs))


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
        serve_state_gate(eng, f"serve_{layout}")
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
         max_abs_logit=scale, limit=DECODE_STEP_BF16_TOL * scale)
    if not diff <= DECODE_STEP_BF16_TOL * scale:
        raise AssertionError("flash and dense decode steps disagree")
    out["profile"] = {layout: profile_decode(torch, out[layout]["eng"], cfg,
                                             params)
                      for layout in ("paged", "dense")}
    return out


def profile_decode(torch, eng, cfg, params) -> dict:
    """Device time by kernel over three decode steps of the engine's
    layout (paged: the split-KV kernel over distinct pool blocks; dense:
    the stripes), and the device's idle share of their wall time
    (informational)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step

    toks = torch.zeros((6,), dtype=torch.long, device="cuda")
    pos = torch.tensor([300, 500, 700, 900, 1000, 1050], dtype=torch.int32,
                       device="cuda")
    cache = {j: {n: t.clone() for n, t in sub.items()}
             for j, sub in eng.cache.items()}
    kw = {}
    if eng.layout == "paged":
        # the pool holds 6 slots' full tables: one distinct block each
        nk = eng.num_blocks // 6
        kw = {"block_tables": torch.arange(6 * nk, dtype=torch.int32,
                                           device="cuda").reshape(6, nk),
              "block_size": eng.block_size}
    decode_step(params, cfg, cache, {"tokens": toks}, pos, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            decode_step(params, cfg, cache, {"tokens": toks}, pos, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    total, by_cat, top = device_busy(prof, 3)
    res = {"wall_ms_per_step": wall * 1e3,
           "device_busy_ms_per_step": total, "busy_ms_by_category": by_cat,
           "idle_share": None if not total else max(0.0, 1 - total
                                                    / (wall * 1e3)),
           "top": top}
    emit(f"profile_{eng.layout}_decode_step", **res)
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
    card = {}
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
        card[layout] = toks["cuda"]
    # f32: the split-KV paged kernel and the dense kernel give the same
    # greedy tokens (at full width in bf16, random weights leave near-ties
    # that the two kernels' rounding breaks differently)
    same = card["paged"] == card["dense"]
    emit("smoke_paged_vs_dense_tokens", identical=same)
    if not same:
        raise AssertionError("paged and dense smoke tokens differ")


# ----------------------------------------------------------------------- #
# doc-attention training kernels: parity and timing
# ----------------------------------------------------------------------- #
def doc_batch(pad: int = 0, grid: str = "flat", step: int = 0):
    """A real wlb_llm batch of the port's pipeline at SEQ tokens (the last
    ``pad`` tokens padding) with its visit tables, on the card."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.steps import batch_to_device
    # aligning to SEQ pads the SEQ - pad tokens of documents to SEQ
    pipe = PipelineConfig(dataset="wlb_llm", context_len=SEQ - pad,
                          batch_per_host=1, cp_size=1, vocab_size=49152,
                          align=SEQ, emit_tables=True, table_grid=grid)
    return batch_to_device(make_batch(pipe, step), "cuda")


def doc_tables(batch, grid: str):
    """(fwd/dQ tables, dKV reverse tables) of rank 0 of a batch."""
    from repro_torch.table_layout import GRID_TABLE_HALF, table_keys
    t = tuple(batch[k][:, 0].contiguous()
              for k in table_keys("tab_loc_", grid))
    h = GRID_TABLE_HALF[grid]
    return t[:h], t[h:]


def visits_of(batch) -> int:
    """Visited (q block, kv block) pairs of a batch's flat (or rect)
    tables."""
    if "tab_loc_fq_flags" not in batch:
        return int(batch["tab_loc_kv_nvis"].sum())
    flags = batch["tab_loc_fq_flags"]
    return int(((flags & 4) != 0).sum())


def doc_inputs(torch, gen, dtype, hq=T_HQ, hkv=T_HKV, d=T_D):
    shape_q = (1, hq, SEQ, d)
    shape_k = (1, hkv, SEQ, d)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in (shape_q, shape_k, shape_k, shape_q)]


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def doc_times(torch, timer, gen, hq=T_HQ, hkv=T_HKV, d=T_D, *,
              phase: str = "kernel_time", **tag) -> dict:
    """bf16 times of the three doc kernels at (hq, hkv, d) on the main
    path's schedule (flat grid, an unpadded SEQ-token batch), bounds from
    this batch's visited blocks, each beside its plain version and SDPA;
    emitted as ``phase`` lines with ``tag``."""
    import torch.nn.functional as F
    from repro_torch.kernels import doc_attention as da
    from repro_torch.kernels.ref import doc_mask

    batch = doc_batch()
    meta = [batch[k] for k in ("doc", "pos", "doc", "pos")]
    fwd_t, rev_t = doc_tables(batch, "flat")
    q, k, v, do = doc_inputs(torch, gen, torch.bfloat16, hq, hkv, d)
    kw = dict(scale=d ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK,
              grid="flat")
    o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    delta = (do.float() * o.float()).sum(-1)
    visits = visits_of(batch)
    mask = doc_mask(batch["doc"], batch["pos"], batch["doc"],
                    batch["pos"])[:, None]
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sd_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                            enable_gqa=True)
    lib = {"flash_fwd": lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = lambda: torch.autograd.grad(
        sd_out, (qg, kg, vg), do, retain_graph=True)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    qkv_b = nbytes(q, k, v)
    meta_b = nbytes(*meta)
    calls = {
        "flash_fwd": (lambda: da.flash_fwd(q, k, v, *meta, fwd_t, **kw),
                      lambda: da.flash_fwd_plain(q, k, v, *meta, fwd_t,
                                                 **kw),
                      qkv_b + meta_b + nbytes(*fwd_t), nbytes(o, lse)),
        "flash_bwd_dq": (
            lambda: da.flash_bwd_dq(q, k, v, do, lse, delta, *meta, fwd_t,
                                    **kw),
            lambda: da.flash_bwd_dq_plain(q, k, v, do, lse, delta, *meta,
                                          fwd_t, **kw),
            qkv_b + nbytes(do, lse, delta) + meta_b + nbytes(*fwd_t),
            nbytes(q)),
        "flash_bwd_dkv": (
            lambda: da.flash_bwd_dkv(q, k, v, do, lse, delta, *meta, rev_t,
                                     **kw),
            lambda: da.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *meta,
                                           rev_t, **kw),
            qkv_b + nbytes(do, lse, delta) + meta_b + nbytes(*rev_t),
            nbytes(k, v))}
    times = {}
    for name, (call, plain, rb, wb) in calls.items():
        flops = visits * hq * MATMULS[name] * 2 * T_BLOCK * T_BLOCK * d
        bms, by = bound_ms(rb, wb, flops, "bfloat16")
        ms = timer(call, reps=20)
        times[name] = {"ms": ms, "plain_ms": timer(plain, reps=20),
                       "library_ms": timer(lib[name], reps=20),
                       "bound_ms": bms, "bound_by": by, "flops": flops,
                       "bytes": rb + wb, "visits": visits,
                       **achieved(ms, rb + wb, flops, bms)}
        emit(phase, **tag, name=name, dtype="bfloat16", **times[name],
             library=("scaled_dot_product_attention forward"
                      if name == "flash_fwd" else
                      "scaled_dot_product_attention backward (dq, dk, dv "
                      "together; shared by both backward rows)"))
    return times


def doc_kernel_phase(torch, timer, quick: bool) -> dict:
    """Each doc kernel vs its twin on a real batch at the training head
    geometry (Hq 24, Hkv 2, D 128, SEQ tokens, blocks 128): f32 and bf16
    on the flat grid with 300 padding tokens (two empty q-block rows and
    a part-empty one), f32 and bf16 on the rect grid (the grid the
    autotuner may pick) under the flat grid's tolerances; then bf16
    times."""
    from repro_torch.kernels import doc_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    err = {n: 0.0 for n in DOC_KERNELS}
    for name, grid, pad in (("float32", "flat", 300), ("bfloat16", "flat", 300),
                            ("float32", "rect", 0), ("bfloat16", "rect", 0)):
        dtype = getattr(torch, name)
        tol = DOC_TOL[name]
        batch = doc_batch(pad=pad, grid=grid)
        meta = [batch[k] for k in ("doc", "pos", "doc", "pos")]
        fwd_t, rev_t = doc_tables(batch, grid)
        q, k, v, do = doc_inputs(torch, gen, dtype)
        kw = dict(scale=T_D ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK,
                  grid=grid)
        o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
        torch.cuda.synchronize()
        po, plse = da.flash_fwd_plain(q, k, v, *meta, fwd_t, **kw)
        empty = torch.isinf(plse)
        fin = ~empty
        e_o = _err(o, po)
        e_lse = (lse[fin] - plse[fin]).abs().max().item()
        empty_ok = bool(torch.equal(torch.isneginf(lse), empty)
                        and (o[empty[..., None].expand_as(o)] == 0).all())
        delta = (do.float() * po.float()).sum(-1)
        dq = da.flash_bwd_dq(q, k, v, do, plse, delta, *meta, fwd_t, **kw)
        dk, dv = da.flash_bwd_dkv(q, k, v, do, plse, delta, *meta, rev_t,
                                  **kw)
        torch.cuda.synchronize()
        pdq = da.flash_bwd_dq_plain(q, k, v, do, plse, delta, *meta, fwd_t,
                                    **kw)
        pdk, pdv = da.flash_bwd_dkv_plain(q, k, v, do, plse, delta, *meta,
                                          rev_t, **kw)
        grads = {"dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
        rel = {n: _err(a, b) / max(b.float().abs().max().item(), 1e-30)
               for n, (a, b) in grads.items()}
        dkv_tol = DKV_BF16_TOL if name == "bfloat16" else tol
        emit("doc_kernel_parity", dtype=name, grid=grid, pad_tokens=pad,
             tol=tol, dkv_tol=dkv_tol, o_err=e_o, lse_err=e_lse,
             grad_rel_err=rel, grad_abs_err={n: _err(a, b) for n, (a, b)
                                             in grads.items()},
             empty_rows=int(empty.sum()), empty_rows_exact=empty_ok,
             visits=visits_of(batch))
        if max(e_o, e_lse, rel["dq"]) > tol or not empty_ok \
                or max(rel["dk"], rel["dv"]) > dkv_tol:
            raise AssertionError(f"doc kernel parity failed: {name} {grid}")
        err["flash_fwd"] = max(err["flash_fwd"], e_o)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], _err(dq, pdq))
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], _err(dk, pdk),
                                   _err(dv, pdv))
        del q, k, v, do, o, po, dq, dk, dv, pdq, pdk, pdv, grads
    for name, e in doc_hop_phase(torch, gen).items():
        err[name] = max(err[name], e)
    if quick:
        return {"err": err}

    # times in the model dtype on the main path's schedule (flat grid, an
    # unpadded batch), bounds from this batch's visited blocks
    return {"err": err, "times": doc_times(torch, timer, gen)}


def cp_batch(cp: int, strategy: str = "flashcp", overlap: str = "chunked",
             step: int = CP_STEP):
    """A 32768-token wlb_llm batch planned for ``cp`` ranks, with the
    flat visit tables of (strategy, overlap); numpy, ``perm`` kept."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    pipe = PipelineConfig(dataset="wlb_llm", context_len=CP_SEQ,
                          batch_per_host=1, cp_size=cp, strategy=strategy,
                          vocab_size=49152, align=T_BLOCK, emit_tables=True,
                          table_overlap=overlap, table_grid="flat")
    return make_batch(pipe, step)


def doc_hop_phase(torch, gen) -> dict:
    """The doc kernels at one CP hop's shape, f32 and bf16: rank 0's
    t_loc queries against the Eq.-5 buffer of hop 0 (rank 3's: buf_len
    keys with their own doc/pos) of a real N = 4 batch, at the training
    heads, through the partial (o, lse) op with a nonzero lse cotangent;
    against the twins with dlse folded into delta as the op folds it."""
    from repro_torch.core.merge import NEG
    from repro_torch.kernels import doc_attention as da
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.steps import batch_to_device
    from repro_torch.table_layout import table_keys

    N, r, h = 4, 0, 0
    batch = batch_to_device(cp_batch(N), "cuda")
    t_loc = batch["doc"].shape[1] // N
    buf = batch["send_idx"].shape[-1]
    src = (r - 1 - h) % N
    meta = [batch["doc"][:, :t_loc].contiguous(),
            batch["pos"][:, :t_loc].contiguous(),
            batch["gath_doc"][:, src * buf:(src + 1) * buf].contiguous(),
            batch["gath_pos"][:, src * buf:(src + 1) * buf].contiguous()]
    tabs = tuple(batch[k][:, r, h].contiguous()
                 for k in table_keys("tab_hop_", "flat"))
    kw = dict(scale=T_D ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK,
              grid="flat")
    err = {n: 0.0 for n in DOC_KERNELS}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        q, do = (torch.randn((1, T_HQ, t_loc, T_D), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, T_HKV, buf, T_D), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        dlse = torch.randn((1, T_HQ, t_loc), generator=gen, device="cuda")
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        o, lse = kops.doc_flash_attention(qg, kg, vg, *meta, tabs,
                                          partial=True, **kw)
        m = torch.clamp(lse, min=NEG)
        dq, dk, dv = torch.autograd.grad(
            (o.float() * do.float()).sum() + (m * dlse).sum(), (qg, kg, vg))
        torch.cuda.synchronize()
        po, plse = da.flash_fwd_plain(q, k, v, *meta, tabs[:3], **kw)
        empty = torch.isinf(plse)
        delta = (do.float() * po.float()).sum(-1) \
            - torch.where(empty, 0.0, dlse)
        pdq = da.flash_bwd_dq_plain(q, k, v, do, plse, delta, *meta,
                                    tabs[:3], **kw)
        pdk, pdv = da.flash_bwd_dkv_plain(q, k, v, do, plse, delta, *meta,
                                          tabs[3:], **kw)
        fin = ~empty
        e_o = _err(o, po)
        e_lse = (lse[fin] - plse[fin]).abs().max().item()
        empty_ok = bool(torch.equal(torch.isinf(lse), empty))
        grads = {"dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
        rel = {n: _err(a, b) / max(b.float().abs().max().item(), 1e-30)
               for n, (a, b) in grads.items()}
        tol = DOC_TOL[name]
        dkv_tol = DKV_BF16_TOL if name == "bfloat16" else tol
        emit("doc_hop_shapes", dtype=name, tq=t_loc, tk=buf, hop=h,
             rank=r, src_rank=src, heads=[T_HQ, T_HKV, T_D], tol=tol,
             dkv_tol=dkv_tol, o_err=e_o, lse_err=e_lse, grad_rel_err=rel,
             empty_rows=int(empty.sum()), empty_rows_exact=empty_ok,
             visits=int(((tabs[2] & 4) != 0).sum()))
        if max(e_o, e_lse, rel["dq"]) > tol or not empty_ok \
                or max(rel["dk"], rel["dv"]) > dkv_tol or t_loc == buf:
            raise AssertionError(f"doc kernels at the hop shape: {name}")
        err["flash_fwd"] = max(err["flash_fwd"], e_o)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], _err(dq, pdq))
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], _err(dk, pdk),
                                   _err(dv, pdv))
    return err


# ----------------------------------------------------------------------- #
# context parallelism: the CP islands and the CP training step
# ----------------------------------------------------------------------- #
def cp_backend(torch, world: int) -> str:
    """NCCL with one rank per card; gloo where ranks share a card (NCCL
    refuses two ranks on one device), its exchange through host memory."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def cp_inputs(torch):
    """q, k, v and the output cotangent w of the island checks, packed
    order, f32 on the CPU, from a seed."""
    gen = torch.Generator().manual_seed(77)
    shape_q, shape_k = (1, T_HQ, CP_SEQ, T_D), (1, T_HKV, CP_SEQ, T_D)
    return [torch.randn(s, generator=gen)
            for s in (shape_q, shape_k, shape_k, shape_q)]


def plan_order(torch, x, perm):
    """Packed order -> the plan positions ``perm`` (1-D; -1 is padding,
    0 there) along the token axis."""
    p = torch.from_numpy(perm)
    out = x[:, :, p.clamp(min=0)]
    return out * (p >= 0)[None, None, :, None].to(x.dtype)


def island_run(torch, batch, q, k, v, w, strategy, overlap, comm,
               wire="native"):
    """One rank's island forward and backward on the card on the K/V
    ``wire``: (o, dq, dk, dv) of this rank's token slice, the seconds it
    took, and the forward's bytes by collective kind (``comm``'s
    ``wire_bytes_by_kind`` and ``wire_peak_by_kind``; None on one
    rank)."""
    from repro_torch.core.cp_attention import make_cp_context
    from repro_torch.data.pipeline import exec_style_of
    from repro_torch.launch.steps import batch_to_device

    arrays = batch_to_device({k_: v_ for k_, v_ in batch.items()
                              if k_ not in ("tokens", "labels", "stats")},
                             "cuda")
    ctx = make_cp_context(arrays, strategy=exec_style_of(strategy),
                          impl="flash", head_dim=T_D, overlap=overlap,
                          block_q=T_BLOCK, block_k=T_BLOCK, grid="flat",
                          kv_comm_dtype=wire, comm=comm)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    torch.cuda.synchronize()
    if comm is not None:
        comm.reset_wire()
    t0 = time.perf_counter()
    o = ctx.attn(q, k, v)
    fwd = None if comm is None else (dict(comm.wire_bytes_by_kind),
                                     dict(comm.wire_peak_by_kind))
    grads = torch.autograd.grad(o, (q, k, v), w)
    torch.cuda.synchronize()
    return [o.detach(), *grads], time.perf_counter() - t0, fwd


def cp_reference(torch, path: str) -> None:
    """The one-rank path on the card over the same sequence, per dtype:
    o, dq, dk, dv in packed order, saved to ``path`` for the ranks."""
    q0, k0, v0, w0 = cp_inputs(torch)
    batch = cp_batch(1)
    perm = batch["perm"]
    ref = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        xs = [plan_order(torch, x, perm[0]).to("cuda", dtype)
              for x in (q0, k0, v0, w0)]
        outs, _, _ = island_run(torch, batch, *xs, "flashcp", "chunked",
                                None)
        p = torch.from_numpy(perm[0]).to("cuda")
        ok = p >= 0
        for n, x in zip(("o", "dq", "dk", "dv"), outs):
            packed = torch.zeros((*x.shape[:2], CP_SEQ, T_D),
                                 dtype=torch.float32, device="cuda")
            packed[:, :, p[ok]] = x.float()[:, :, ok]
            ref[f"{name}/{n}"] = packed.cpu()
        del xs, outs
    torch.save(ref, path)


def join_env(rank: int, world: int, backend: str, port: int):
    """Join the default group through env://, with the variables a
    launcher such as torchrun sets; this rank's CP group of the whole
    world and its device."""
    import os
    from repro_torch.launch.ranks import init_rank

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    return init_rank(rank, world, backend, None, "cuda")


def first_ranks_comms(comm, backend: str, sizes) -> dict:
    """{n: the CP group of ranks 0..n-1} for each of ``sizes``, made on
    every rank in one order (``dist.new_group`` is collective over the
    default group); None on a rank outside it."""
    import torch.distributed as dist
    from repro_torch.core.comm import CPComm

    out = {}
    for n in sorted(set(sizes)):
        if n == comm.size:
            out[n] = comm
            continue
        group = dist.new_group(list(range(n)))
        out[n] = CPComm(backend, group) if comm.rank < n else None
    return out


def cp_island_rank(rank, world, backend, port, out_dir, ref_path, cases,
                   decode_path):
    """One rank of the island checks, joined through env://: each (N,
    strategy, overlap, wire) case on the first N ranks, in f32 and bf16
    on this rank's token slice, its outputs and gradients held against
    the one-rank path at the same packed positions, and the K/V bytes
    this rank handed to its ``CPComm`` per pass; on the native wire, the
    forward's bytes by collective kind audited against the island's
    analytic budget (``audit_wire``: WIRE101-WIRE103); then, in the same
    group, the sharded decode of ``decode_path`` (``serve_sharded``'s,
    :func:`sharded_decode_rows`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.wire_audit import audit_wire, island_budget
    from repro_torch.data.pipeline import exec_style_of

    comm, dev = join_env(rank, world, backend, port)
    try:
        comms = first_ranks_comms(comm, backend,
                                  [c[0] for c in cases] + list(SHARDS))
        ref = torch.load(ref_path)
        q0, k0, v0, w0 = cp_inputs(torch)
        out = []
        for n, strategy, overlap, wire in cases:
            cn = comms[n]
            if cn is None:
                continue
            batch = cp_batch(n, strategy, overlap)
            perm = batch["perm"]
            t_loc = perm.shape[1] // n
            my = slice(rank * t_loc, (rank + 1) * t_loc)
            pm = torch.from_numpy(perm[0, my])
            ok = pm >= 0
            hop = batch.get("tab_hop_fq_flags")
            info = {"world": n, "strategy": strategy, "overlap": overlap,
                    "wire": wire, "rank": rank, "t_loc": t_loc,
                    "tokens": int(ok.sum()),
                    "plan_comm_tokens": batch["stats"]["comm_tokens"],
                    "buf_len": batch["send_idx"].shape[-1],
                    "comm_tokens": int((batch["send_idx"][0, rank]
                                        >= 0).sum()),
                    "visits_per_hop": None if hop is None else
                    [int(x) for x in ((hop[0, rank] & 4) != 0).sum(-1)]}
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                xs = [plan_order(torch, x, perm[0, my]).to("cuda", dtype)
                      for x in (q0, k0, v0, w0)]
                reset_counts()
                outs, sec, (kinds, peak) = island_run(
                    torch, batch, *xs, strategy, overlap, cn, wire)
                audit = None
                if wire == "native":
                    style = exec_style_of(strategy)
                    budget = island_budget(
                        style, overlap, buf_len=info["buf_len"]
                        if style in ("flashcp", "contiguous") else t_loc,
                        num_workers=n, kv_heads=T_HKV, head_dim=T_D,
                        dtype_bytes=4 if name == "float32" else 2)
                    audit = {"counted": {k: v for k, v in kinds.items()
                                         if v},
                             "allowed": budget.allowed,
                             "findings": [
                                 [f.rule, f.severity, f.render()]
                                 for f in audit_wire(
                                     kinds, budget, largest=peak,
                                     context=f"{strategy}/{overlap} N={n} "
                                             f"{name} rank {rank}")]}
                rel = {}
                for x_, x in zip(("o", "dq", "dk", "dv"), outs):
                    want = ref[f"{name}/{x_}"]
                    got = x.float()[:, :, ok.to("cuda")].cpu()
                    rel[x_] = (got - want[:, :, pm[ok]]).abs().max().item() \
                        / max(want.abs().max().item(), 1e-30)
                out.append({**info, "dtype": name, "rel_err": rel,
                            "seconds": sec, "launches": read_counts(),
                            "wire_bytes": dict(cn.wire_bytes),
                            "wire_audit": audit})
                del xs, outs
        decode = sharded_decode_rows(torch, rank, comms, dev, decode_path)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump({"islands": out, "decode": decode}, f)
    finally:
        dist.destroy_process_group()


def _pool_worker(rank: int, jobs, results) -> None:
    """One process of the rank pool: runs ``fn(rank, *args)`` for each
    ``(fn, args)`` it is handed until it gets None, reporting each job's
    traceback (None when it ran through); each job joins its own process
    group and leaves it, and the worker returns the job's device memory
    to the card after it."""
    import traceback
    import torch

    while True:
        job = jobs.get()
        if job is None:
            return
        fn, args = job
        try:
            fn(rank, *args)
            err = None
        except Exception:
            err = traceback.format_exc()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        results.put((rank, err))


class RankPool:
    """RANK_POOL worker processes started once (each rank phase's spawn
    paid 10-25 s of process start and CUDA initialization before any
    work) and handed the rank phases one after another: a job of
    ``world`` ranks runs on workers 0..world-1, rank r on worker r."""

    def __init__(self, torch, size: int):
        ctx = torch.multiprocessing.get_context("spawn")
        self.jobs = [ctx.SimpleQueue() for _ in range(size)]
        self.results = ctx.SimpleQueue()
        self.procs = [ctx.Process(target=_pool_worker,
                                  args=(r, self.jobs[r], self.results),
                                  daemon=True) for r in range(size)]
        # the workers of the job handed out and not yet waited for
        self.pending = None
        for p in self.procs:
            p.start()

    def run(self, fn, world: int, args: tuple, timeout: float) -> None:
        """``fn(rank, *args)`` on ranks 0..world-1; raises what a rank
        raised, or ``TimeoutError`` once ``timeout`` s have passed (the
        pool is then closed: a rank may hang in a collective)."""
        self.start(fn, world, args)
        self.finish(world, timeout)

    def start(self, fn, world: int, args: tuple) -> None:
        """Hand ``fn(rank, *args)`` to workers 0..world-1 and return at
        once; :meth:`finish` waits for it.  One job at a time: a second
        job before the first is waited for raises."""
        if self.pending is not None:
            raise RuntimeError(f"the rank pool's job on {self.pending} "
                               f"workers is still running")
        self.pending = world
        for r in range(world):
            self.jobs[r].put((fn, args))

    def finish(self, world: int, timeout: float) -> None:
        """Wait for the job :meth:`start` handed to ``world`` workers, as
        :meth:`run` does."""
        if self.pending != world:
            raise RuntimeError(f"no job on {world} workers to wait for "
                               f"(pending: {self.pending})")
        try:
            self._collect(world, timeout)
        finally:
            self.pending = None

    def _collect(self, world: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        errors, pending = [], set(range(world))
        while pending:
            if self.results.empty():
                dead = [r for r in pending if not self.procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise (TimeoutError(f"ranks {sorted(pending)} still "
                                        f"running after {timeout} s")
                           if not dead else
                           AssertionError(f"rank workers {dead} died"))
                time.sleep(0.05)
                continue
            rank, err = self.results.get()
            pending.discard(rank)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))

    def close(self) -> None:
        """Stop every worker (a clean exit where it is idle)."""
        for p, q in zip(self.procs, self.jobs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


_POOL: list = []


def rank_pool(torch) -> RankPool:
    """The script's rank pool, started at first use."""
    if not _POOL or not all(p.is_alive() for p in _POOL[0].procs):
        _POOL[:] = [RankPool(torch, RANK_POOL)]
    return _POOL[0]


def close_rank_pool() -> None:
    while _POOL:
        _POOL.pop().close()


class PendingRanks:
    """A job of ``world`` ranks handed to the rank pool, its FileStore
    and output directory; :meth:`wait` gives their JSON results, by
    rank."""

    def __init__(self, torch, fn, world: int, args: tuple):
        import tempfile

        self.pool, self.world = rank_pool(torch), world
        self.tmp = tempfile.TemporaryDirectory()
        tmp = self.tmp.name
        self.pool.start(fn, world, (world, cp_backend(torch, world),
                                    f"{tmp}/store", tmp, *args))

    def wait(self, timeout=RANK_TIMEOUT) -> list:
        try:
            self.pool.finish(self.world, timeout)
            out = []
            for r in range(self.world):
                with open(Path(self.tmp.name) / f"rank{r}.json") as f:
                    out.append(json.load(f))
            return out
        finally:
            self.tmp.cleanup()


def run_ranks(torch, fn, world: int, *args, timeout=RANK_TIMEOUT) -> list:
    """``world`` ranks of ``fn(rank, world, backend, store, out_dir,
    *args)`` on the rank pool (the kernels are built already), joined
    through a FileStore; their JSON results, by rank."""
    return PendingRanks(torch, fn, world, args).wait(timeout)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks_env(torch, fn, world: int, *args,
                  timeout=RANK_TIMEOUT) -> list:
    """:func:`run_ranks` for ranks ``fn(rank, world, backend, port,
    out_dir, *args)`` that join through env:// (:func:`join_env`) on a
    free localhost port."""
    import tempfile

    backend = cp_backend(torch, world)
    with tempfile.TemporaryDirectory() as tmp:
        rank_pool(torch).run(fn, world, (world, backend, free_port(), tmp,
                                         *args), timeout)
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.json") as f:
                out.append(json.load(f))
    return out


def island_launches(world: int, overlap: str) -> dict:
    """Each doc kernel's launches on one rank for one island forward and
    backward: once on the local KV and once per hop (chunked), or once
    over the whole gathered KV (none)."""
    n = world if overlap == "chunked" else 1
    return {name: n for name in DOC_KERNELS}


def island_gate(rows, tol: dict, what: str) -> dict:
    """The largest relative error of each of o, dq, dk, dv over the
    ranks' ``rows``; raises past ``tol``."""
    err = {n: max(x["rel_err"][n] for x in rows) for n in tol}
    if any(err[n] > tol[n] for n in tol):
        raise AssertionError(f"CP island {what} disagrees with one rank: "
                             f"{err}")
    return err


def wire_gate(rows, what: str) -> None:
    """The ranks' wire audits of one native island case: emitted, and an
    error finding (WIRE101-WIRE103) fails the run."""
    emit("cp_wire_audit", case=what, ranks=[
        {"rank": r["rank"], **r["wire_audit"]} for r in rows])
    bad = [f[2] for r in rows for f in r["wire_audit"]["findings"]
           if f[1] == "error"]
    if bad:
        raise AssertionError(f"CP island {what}: wire audit\n"
                             + "\n".join(bad))


def cp_islands_phase(torch, decode_inputs: dict) -> None:
    """The CP islands at full-width starcoder2_3b attention (Hq 24, Hkv 2,
    D 128, flat tables, the CUDA kernels in partial mode) on one 32768-
    token sequence, f32 and bf16, each case against the one-rank path,
    on the native K/V wire and (``CP_INT8``) on the int8 wire; per rank its tokens, Eq.-5 bucket, sent tokens, visits
    per hop and the K/V bytes it handed to its ``CPComm`` (counted from
    the tensors sent, each pass), beside the plan's Eq. 5 figure and the
    Eq. 4 one of a full-KV exchange (``repro_torch.core.workload``).  An
    int8 case also has its native case's launches, and sends (D + 4) /
    (esize D) of its forward bytes and all of its backward's.  Every case
    runs in one spawn of 4 ranks joined through env:// (N = 2 on its
    first two ranks), which then runs ``serve_sharded``'s sharded decode
    of ``decode_inputs`` (:func:`sharded_decode_report` gates it)."""
    import tempfile
    from repro_torch.core.workload import comm_bytes, comm_tokens_static

    with tempfile.TemporaryDirectory() as tmp:
        ref = f"{tmp}/ref.pt"
        t0 = time.perf_counter()
        cp_reference(torch, ref)
        gc.collect()
        torch.cuda.empty_cache()
        emit("cp_reference", seq=CP_SEQ, step=CP_STEP,
             seconds=time.perf_counter() - t0)
        # every case in one spawn of the largest world, joined through
        # env://; a smaller N runs on its first N ranks
        cases = [(w, s, o, "native") for w, s, o in CP_ISLANDS] + \
            [(w, s, o, "int8") for w, s, o in CP_INT8]
        world = max(w for w, _, _, _ in cases)
        torch.save(decode_inputs, f"{tmp}/decode.pt")
        t0 = time.perf_counter()
        ranks = run_ranks_env(torch, cp_island_rank, world, ref, cases,
                              f"{tmp}/decode.pt")
    backend = cp_backend(torch, world)
    emit("cp_islands_spawn", world=world, backend=backend,
         rendezvous="env://", seconds=time.perf_counter() - t0)
    results = [x for r in ranks for x in r["islands"]]
    sharded_decode_report([x for r in ranks for x in r["decode"]],
                          decode_inputs)
    for n, strategy, overlap, wire in cases:
        for name in ("float32", "bfloat16"):
            def rows_of(w):
                return [x for x in results if x["world"] == n
                        and x["strategy"] == strategy
                        and x["overlap"] == overlap
                        and x["wire"] == w and x["dtype"] == name]
            rows = rows_of(wire)
            what = f"{strategy}/{overlap} at N={n} ({name}, {wire} wire)"
            tol = CP_INT8_TOL if wire == "int8" else \
                {x: CP_TOL[name] for x in CP_INT8_TOL}
            esize = 4 if name == "float32" else 2
            kw = dict(dtype_bytes=esize)
            emit("cp_islands", world=n, backend=backend,
                 exchange=("gloo through host memory, not NVLink"
                           if backend == "gloo" else "nccl"),
                 strategy=strategy, overlap=overlap, wire=wire, dtype=name,
                 tol=tol,
                 rel_err={x: max(r["rel_err"][x] for r in rows)
                          for x in tol},
                 wire_bytes={p: sum(r["wire_bytes"][p] for r in rows)
                             for p in ("forward", "backward")},
                 eq5_bytes=comm_bytes(rows[0]["plan_comm_tokens"], n, T_HKV,
                                      T_D, **kw),
                 eq4_bytes=comm_bytes(comm_tokens_static(CP_SEQ, n), n,
                                      T_HKV, T_D, **kw),
                 seconds=max(r["seconds"] for r in rows),
                 ranks=[{k: r[k] for k in (
                     "rank", "tokens", "t_loc", "buf_len", "comm_tokens",
                     "visits_per_hop", "seconds", "launches",
                     "wire_bytes")} for r in rows])
            if len(rows) != n:
                raise AssertionError(f"CP island {what}: {len(rows)} ranks "
                                     "reported")
            island_gate(rows, tol, what)
            if wire == "native":
                wire_gate(rows, what)
            want = island_launches(n, overlap)
            if any(r["launches"][k] != want[k] for r in rows for k in want):
                raise AssertionError(
                    f"CP island {what} launched "
                    f"{[r['launches'] for r in rows]}, want {want} per rank")
            if wire == "native":
                continue
            native = rows_of("native")
            if [r["launches"] for r in rows] != \
                    [r["launches"] for r in native]:
                raise AssertionError(f"CP island {what}: launches differ "
                                     "from the native wire")
            for r, y in zip(rows, native):
                q8, nat = r["wire_bytes"], y["wire_bytes"]
                if q8["forward"] * esize * T_D != \
                        nat["forward"] * (T_D + 4) or \
                        q8["backward"] != nat["backward"] or \
                        not nat["forward"]:
                    raise AssertionError(
                        f"CP island {what}: rank {r['rank']} sent {q8} "
                        f"against the native wire's {nat}")


def cp_train_args(*extra):
    return train_args("--arch", ARCH, "--layers", str(CP_TRAIN_LAYERS),
                      "--seq-len", str(CP_SEQ), "--batch", "1",
                      "--steps", str(CP_TRAIN_STEPS), "--device", "cuda",
                      "--log-every", "100", *extra)


def named(tree, prefix: str = "") -> list:
    """(name, tensor) leaves in sorted-key order; a stacked layer leaf
    is split into one entry per layer."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named(tree[k], f"{prefix}/{k}" if prefix else k)]
    if prefix.startswith("layers/"):
        return [(f"{prefix}[{i}]", t) for i, t in enumerate(tree)]
    return [(prefix, tree)]


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float()


def step0_grads(dtype: str, mesh=None, device="cuda", backend=None, *,
                layers: int = CP_TRAIN_LAYERS, seq: int = CP_SEQ,
                batch: int = 1, norm_only: bool = False, arch: str = ARCH,
                cfg_kw=None, smoke: bool = False) -> tuple:
    """Step 0's loss and whole gradients ({leaf: grad} on the host) of a
    training run's model (``arch`` at full width, or at smoke width with
    ``smoke``; ``layers`` deep, 0 keeping the config's; its config fields
    replaced by ``cfg_kw``) and stream (``seq`` tokens x ``batch`` rows),
    on one rank (``mesh`` None) or as this rank of ``mesh`` over
    ``backend`` (ZeRO-3 shards, gathered whole for the comparison);
    ``dtype`` float32 widens the bf16 parameters.  The run asks for
    flashcp, which a recurrent family trains on as ``contiguous``.  With
    ``norm_only`` (one rank), the gradients' global norm in their place."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.launch.steps import (batch_to_device, build_train_step,
                                          effective_strategy)
    from repro_torch.models import init_params
    from repro_torch.runtime.zero import Zero3, tree_shapes

    base = get_config(arch)
    if smoke:
        base = reduce_for_smoke(base)
    cfg = dataclasses.replace(base, num_layers=layers or base.num_layers,
                              **(cfg_kw or {}))
    run = RunConfig(arch=arch, cp_strategy="flashcp", attention_impl="flash",
                    kernel_grid="flat", seed=0)
    cp = 1 if mesh is None else mesh_axes(mesh)["model"]
    pipe = PipelineConfig(
        dataset="wlb_llm", context_len=seq, batch_per_host=batch, cp_size=cp,
        strategy=effective_strategy(cfg, run.cp_strategy),
        vocab_size=cfg.vocab_size, seed=0, align=128,
        emit_tables=cfg.uses_attention, table_overlap=run.cp_overlap,
        table_grid=run.kernel_grid)
    params = init_params(cfg, seed=0, device=device)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype=dtype)
        params = _widen(params)
    zero = None
    if mesh is not None:
        zero = Zero3(mesh, backend, tree_shapes(params))
        params = zero.shard(params)
    step = build_train_step(cfg, run, q_chunk=128, device=device, zero=zero)
    b = batch_to_device(make_batch(pipe, 0), device)
    (loss, _), grads = step.loss_and_grads(params, b)
    del params
    if norm_only:
        from repro_torch.optim import global_norm
        return float(loss), float(global_norm(grads))
    if zero is not None:
        grads = zero.gather_full(grads)
    return float(loss), {n: g.detach().cpu() for n, g in named(grads)}


def compare_grads(got: dict, want: dict) -> dict:
    """``got`` against ``want`` ({leaf: grad}): global norms, the whole
    gradient's relative error, and per leaf its relative error
    ||got - want|| / ||want|| and its share of the squared-norm gap
    (leaves by falling error)."""
    rows, sq_got, sq_want, sq_diff = [], 0.0, 0.0, 0.0
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        nw, ng, nd = w.norm().item(), g.norm().item(), (g - w).norm().item()
        sq_got, sq_want, sq_diff = (sq_got + ng ** 2, sq_want + nw ** 2,
                                    sq_diff + nd ** 2)
        rows.append({"leaf": name, "norm": nw, "rel_err": nd / max(nw, 1e-30),
                     "norm_sq_gap": ng ** 2 - nw ** 2})
    for r in rows:
        r["norm_sq_gap"] /= sq_want
    return {"gnorm": sq_got ** 0.5, "gnorm_ref": sq_want ** 0.5,
            "gnorm_rel_diff": (sq_got / sq_want) ** 0.5 - 1.0,
            "grad_rel_err": (sq_diff / sq_want) ** 0.5,
            "leaves": sorted(rows, key=lambda r: -r["rel_err"])}


def zero_state(res) -> dict:
    """A ZeRO-3 rank's state after ``train``: whether every parameter and
    optimizer leaf has exactly the layout's shard shape, and its bytes."""
    from repro_torch.runtime.zero import named_leaves

    zero, opt = res["zero"], res["opt_state"]
    want = zero.shard_shapes()
    trees = [res["params"]] + [opt[k] for k in ("master", "mu", "nu")
                               if k in opt]
    leaves_ = [x for t in trees for x in named_leaves(t)]
    return {"shapes_ok": all(tuple(x.shape) == want[p] for p, x in leaves_),
            "state_bytes": sum(x.numel() * x.element_size()
                               for _, x in leaves_ + [("", opt["count"])])}


def expected_state_bytes(params, mesh_shape,
                         names=("data", "model")) -> dict:
    """The state bytes of a ZeRO-3 run summed over its ranks: one copy of
    the bf16 parameters, fp32 master, mu and nu (and a count per rank),
    plus the copies of the leaves the layout keeps whole over an axis;
    ``mesh_shape`` the sizes of the mesh's axes ``names``."""
    import math
    from repro_torch.runtime.sharding import param_specs, replicated_axes
    from repro_torch.runtime.zero import named_leaves, tree_shapes

    axes = dict(zip(names, mesh_shape))
    specs = param_specs(axes, tree_shapes(params))
    named_ = named_leaves(params)
    # mu and nu, and an fp32 master where any leaf is stored below fp32
    f32_state = 12 if any(x.element_size() < 4 for _, x in named_) else 8
    one = extra = 0
    for p, x in named_:
        per = x.numel() * (x.element_size() + f32_state)
        reps = math.prod(axes[a] for a in replicated_axes(specs[p], axes))
        one += per
        extra += (reps - 1) * per
    world = math.prod(mesh_shape)
    return {"one_copy": one + 4, "replicated_extra": extra + 4 * (world - 1),
            "total": one + extra + 4 * world}


def cp_train_rank(rank, world, backend, store, out_dir, grad_dir):
    """One rank of the CP training run on a ``1xN`` mesh (ZeRO-3): step
    0's gradients (rank 0 saves them to ``grad_dir``), then ``train``;
    its state's shard shapes and bytes."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank
    from repro_torch.models import init_params

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(1, world, device_type="cuda")
        _, grads = step0_grads("bfloat16", mesh, dev, backend)
        if rank == 0:
            torch.save(grads, Path(grad_dir) / "grads.pt")
        del grads
        args = cp_train_args("--mesh", f"1x{world}", "--dist-backend",
                             backend)
        cfg = dataclasses.replace(get_config(ARCH),
                                  num_layers=CP_TRAIN_LAYERS)
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = train(args, params=params, mesh=mesh, device=dev)
        launches = read_counts()
        out = {"rank": rank, "losses": res["losses"],
               "grad_norms": res["grad_norms"], "step_s": res["step_s"],
               "tokens": res["tokens"],
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               **zero_state(res), "launches": launches}
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
        out["pod"] = pod_train_rank(rank, dev, backend, grad_dir)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def pod_train_rank(rank, dev, backend, grad_dir) -> dict:
    """``pod_train`` on this rank of cp_train's job: the 2x1x2 (pod, data,
    model) mesh of the same 4 ranks, dp_train's model (bf16, fp32 master)
    and first batch (2 rows: one per pod, its tokens over model), ZeRO-3
    over all three axes.  Step 0's loss and whole gradients (rank 0 saves
    them to ``grad_dir``) and their doc-kernel launches, then the
    update from them: the step's grad norm, the state finite, and this
    rank's state against the layout's shard shapes."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.mesh import POD_AXES, make_mesh, mesh_coords
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim._slices import leaves
    from repro_torch.runtime.zero import Zero3, tree_shapes

    marks = [("start", time.perf_counter())]
    mesh = make_mesh(POD_MESH, POD_AXES, device_type="cuda")
    cfg = dataclasses.replace(get_config(ARCH), num_layers=DP_LAYERS)
    run = RunConfig(arch=ARCH, cp_strategy="flashcp", attention_impl="flash",
                    kernel_grid="flat", seed=0)
    pipe = PipelineConfig(
        dataset="wlb_llm", context_len=DP_SEQ, batch_per_host=DP_BATCH,
        cp_size=POD_MESH[-1], strategy="flashcp", vocab_size=cfg.vocab_size,
        seed=0, align=128, emit_tables=True, table_overlap=run.cp_overlap,
        table_grid=run.kernel_grid)
    params = init_params(cfg, seed=0, device=dev)
    zero = Zero3(mesh, backend, tree_shapes(params))
    params = zero.shard(params)
    opt = adamw_init(params)
    torch.cuda.empty_cache()
    step = build_train_step(cfg, run, q_chunk=128, device=dev, zero=zero)
    batch = batch_to_device(make_batch(pipe, 0), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    marks.append(("setup", time.perf_counter()))
    (loss, _), grads = step.loss_and_grads(params, batch)
    launches = read_counts()
    torch.cuda.synchronize(dev)
    marks.append(("grads", time.perf_counter()))
    whole = zero.gather_full(grads)
    marks.append(("gather", time.perf_counter()))
    if rank == 0:
        torch.save({n: g.detach().cpu() for n, g in named(whole)},
                   Path(grad_dir) / "pod_grads.pt")
    del whole
    marks.append(("save", time.perf_counter()))
    # the rest of the step from these gradients (a second forward and
    # backward through gloo, train_step whole, would cost ~14 s)
    gnorm, _ = step.apply_grads(params, opt, grads, 0)
    torch.cuda.synchronize(dev)
    marks.append(("update", time.perf_counter()))
    state = zero_state({"zero": zero, "params": params, "opt_state": opt})
    finite = math.isfinite(float(loss)) and math.isfinite(float(gnorm)) \
        and all(bool(torch.isfinite(p).all()) for p in leaves(params))
    return {"coords": mesh_coords(mesh), "loss0": float(loss),
            "grad_norm": float(gnorm), "finite": finite,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "seconds": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])},
            "launches": launches, **state}


def check_zero_state(what: str, ranks, want: dict) -> None:
    """Every rank holds exactly the layout's shard shapes, and the state
    bytes summed over the ranks are one copy plus the replicated
    leaves'."""
    if not all(x["shapes_ok"] for x in ranks):
        raise AssertionError(f"{what}: a rank holds other than its ZeRO-3 "
                             "shard shapes")
    got = sum(x["state_bytes"] for x in ranks)
    if got != want["total"]:
        raise AssertionError(f"{what}: the ranks hold {got} state bytes, "
                             f"the layout {want}")


def cp_train_phase(torch) -> dict:
    """Full-width starcoder2_3b cut to CP_TRAIN_LAYERS layers, bf16 with
    an fp32 master, flashcp over N ranks (ZeRO-3 on a 1xN mesh) on one
    32768-token sequence per step: step 0's loss, grad norm and every
    gradient leaf but the embedding table against the one-rank step on
    the same batch from the same parameters; every loss finite; every
    rank's launches exactly layers x steps x (1 + N-1 hops) x (2, 1, 1);
    every rank's shard shapes those of the layout, and the state bytes
    over the ranks one copy plus the replicated leaves.  The same job
    then runs ``pod_train`` on the same ranks (:func:`pod_train_rank`,
    :func:`pod_train_report`) against dp_train's one-rank step 0, made
    here and handed on to dp_train."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import POD_AXES
    from repro_torch.models import init_params

    world = CP_TRAIN_WORLD
    _, g1 = step0_grads("bfloat16")
    torch.cuda.empty_cache()
    # pod_train's one-rank step 0, which is dp_train's too
    t0 = time.perf_counter()
    dp_one = step0_grads("bfloat16", layers=DP_LAYERS, seq=DP_SEQ,
                         batch=DP_BATCH)
    dp_one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ARCH), num_layers=CP_TRAIN_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    want_bytes = expected_state_bytes(params, (1, world))
    pod_bytes = expected_state_bytes(
        init_params(dataclasses.replace(cfg, num_layers=DP_LAYERS), seed=0,
                    device="cuda"), POD_MESH, POD_AXES)
    # one rank, step 0 of the same stream from the same parameters
    torch.cuda.reset_peak_memory_stats()
    res1 = train(cp_train_args("--steps", "1"), params=params)
    one = {"loss": res1["losses"][0], "grad_norm": res1["grad_norms"][0],
           "step_s": res1["step_s"][0],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, res1
    gc.collect()
    torch.cuda.empty_cache()

    backend = cp_backend(torch, world)
    with tempfile.TemporaryDirectory() as grad_dir:
        t0 = time.perf_counter()
        ranks = run_ranks(torch, cp_train_rank, world, grad_dir)
        wall = time.perf_counter() - t0
        leaf = compare_grads(torch.load(Path(grad_dir) / "grads.pt"), g1)
        pod_leaf = compare_grads(torch.load(Path(grad_dir) / "pod_grads.pt"),
                                 dp_one[1])
    del g1
    r0 = ranks[0]
    d_loss = abs(r0["losses"][0] - one["loss"]) / abs(one["loss"])
    d_norm = abs(r0["grad_norms"][0] - one["grad_norm"]) / one["grad_norm"]
    gated = [r for r in leaf["leaves"] if r["leaf"] != EMBED_LEAF]
    embed = next(r for r in leaf["leaves"] if r["leaf"] == EMBED_LEAF)
    want = {n: CP_TRAIN_LAYERS * CP_TRAIN_STEPS * world * k
            for n, k in (("flash_fwd", 2), ("flash_bwd_dq", 1),
                         ("flash_bwd_dkv", 1))}
    per_rank = []
    for x in ranks:
        step_s = statistics.mean(x["step_s"][1:])
        per_rank.append({"rank": x["rank"], "losses": x["losses"],
                         "grad_norms": x["grad_norms"], "step_s": x["step_s"],
                         "step_s_after_first": step_s,
                         "tokens_per_s": CP_SEQ / step_s,
                         "peak_bytes": x["peak_bytes"],
                         "shapes_ok": x["shapes_ok"],
                         "state_bytes": x["state_bytes"],
                         "launches": x["launches"]})
    emit("cp_train", arch=ARCH, layers=CP_TRAIN_LAYERS, world=world,
         backend=backend,
         exchange=("gloo through host memory, not NVLink"
                   if backend == "gloo" else "nccl"),
         seq_len=CP_SEQ, t_loc=CP_SEQ // world, steps=CP_TRAIN_STEPS,
         one_rank_step0=one, loss_rel_diff=d_loss, grad_norm_rel_diff=d_norm,
         tol=CP_TRAIN_TOL, grad_rel_err=leaf["grad_rel_err"],
         worst_leaves=gated[:6], embed_leaf=embed, embed_leaf_not_gated=F2,
         expected_launches=want, expected_state_bytes=want_bytes,
         wall_s=wall, ranks=per_rank)
    finite = all(math.isfinite(v) for x in ranks
                 for v in x["losses"] + x["grad_norms"])
    if not finite:
        raise AssertionError("CP training produced non-finite losses")
    if not (d_loss <= CP_TRAIN_TOL and d_norm <= CP_TRAIN_TOL):
        raise AssertionError("CP and one-rank training steps disagree")
    if gated[0]["rel_err"] > CP_TRAIN_TOL:
        raise AssertionError(f"CP step-0 gradient of {gated[0]['leaf']} is "
                             f"{gated[0]['rel_err']:.3g} from one rank's")
    check_zero_state("CP training", ranks, want_bytes)
    if any(x["launches"][n] != want[n] for x in ranks for n in want):
        raise AssertionError(f"CP training launches "
                             f"{[x['launches'] for x in ranks]}, want {want} "
                             "per rank")
    pod = pod_train_report([x["pod"] for x in ranks], dp_one[0], pod_leaf,
                           pod_bytes)
    return {"ranks": per_rank, "pod": pod,
            "dp_one": (*dp_one, dp_one_s)}


def pod_train_report(ranks, loss1: float, leaf: dict, want_bytes) -> dict:
    """``pod_train`` (run in cp_train's job, :func:`pod_train_rank`)
    against the one-rank step 0 on the same batch: the loss, the grad
    norm and every gradient leaf but the embedding table within
    CP_TRAIN_TOL; a finite step; every rank's launches layers x (1 + 1
    hop) x (2, 1, 1) in its forward and backward; every rank's shards
    and the state bytes over the ranks as the layout gives them."""
    cp = POD_MESH[-1]
    want = {n: DP_LAYERS * cp * k for n, k in (("flash_fwd", 2),
                                               ("flash_bwd_dq", 1),
                                               ("flash_bwd_dkv", 1))}
    d_loss = abs(ranks[0]["loss0"] - loss1) / abs(loss1)
    gated = [r for r in leaf["leaves"] if r["leaf"] != EMBED_LEAF]
    embed = next(r for r in leaf["leaves"] if r["leaf"] == EMBED_LEAF)
    out = {"mesh": dict(zip(("pod", "data", "model"), POD_MESH)),
           "arch": ARCH, "layers": DP_LAYERS, "seq_len": DP_SEQ,
           "batch": DP_BATCH, "loss": ranks[0]["loss0"],
           "one_rank_loss": loss1, "loss_rel_diff": d_loss,
           "grad_norm_rel_diff": leaf["gnorm_rel_diff"],
           "grad_rel_err": leaf["grad_rel_err"], "tol": CP_TRAIN_TOL,
           "worst_leaves": gated[:6], "embed_leaf": embed,
           "embed_leaf_not_gated": F2, "expected_launches": want,
           "expected_state_bytes": want_bytes,
           "ranks": [{k: x[k] for k in ("coords", "grad_norm", "peak_bytes",
                                        "seconds", "launches", "shapes_ok",
                                        "state_bytes")}
                     for x in ranks]}
    emit("pod_train", **out)
    if not all(x["finite"] for x in ranks):
        raise AssertionError("pod training produced a non-finite value")
    if not (d_loss <= CP_TRAIN_TOL
            and abs(leaf["gnorm_rel_diff"]) <= CP_TRAIN_TOL):
        raise AssertionError("the 2x1x2 and one-rank steps disagree")
    if gated[0]["rel_err"] > CP_TRAIN_TOL:
        raise AssertionError(f"2x1x2 step-0 gradient of {gated[0]['leaf']} "
                             f"is {gated[0]['rel_err']:.3g} from one rank's")
    check_zero_state("pod training", ranks, want_bytes)
    if any(x["launches"][n] != want[n] for x in ranks for n in want):
        raise AssertionError(f"pod training launches "
                             f"{[x['launches'] for x in ranks]}, want {want} "
                             "per rank")
    return {"state_bytes": [x["state_bytes"] for x in ranks]}


def dryrun_cell_rank(rank, world, backend, store, out_dir, cells):
    """Worker ``rank`` of the pool traces dry-run cell ``rank`` on the
    host (``launch.dryrun.run_cell``; no process group, no card)."""
    import dataclasses
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch.dryrun import run_cell

    cell = cells[rank]
    cfg = get_config(cell["arch"])
    if cell.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=cell["layers"])
    shape = SHAPES.get(cell["shape"]) or ShapeConfig(*cell["shape_spec"])
    t0 = time.perf_counter()
    rec = run_cell(cell["arch"], cell["shape"],
                   multi_pod=cell.get("multi_pod", False),
                   axes=cell.get("axes"), cfg=cfg, shape=shape)
    rec["trace_s"] = time.perf_counter() - t0
    rec["cell"] = cell["name"]
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)


def dryrun_start(torch) -> tuple:
    """Hand the dry run's three cells to the rank pool's workers, which
    trace them on the host while the card runs the next phases of this
    process; :func:`dryrun_phase` waits for them."""
    arch, shape, multi = DRYRUN_PROD
    cells = [
        {"name": "main_path", "arch": ARCH, "shape": "main_path",
         "shape_spec": ("main_path", SEQ, 1, "train"),
         "axes": {"data": 1, "model": 1}},
        {"name": "pod_train", "arch": ARCH, "shape": "pod_train",
         "shape_spec": ("pod_train", DP_SEQ, DP_BATCH, "train"),
         "axes": dict(zip(("pod", "data", "model"), POD_MESH)),
         "layers": DP_LAYERS},
        {"name": "production", "arch": arch, "shape": shape,
         "multi_pod": multi}]
    return (PendingRanks(torch, dryrun_cell_rank, len(cells), (cells,)),
            time.perf_counter())


def dryrun_phase(torch, trained: dict, pod: dict, pending: tuple) -> dict:
    """The per-rank dry run (``launch.dryrun``) traced on the host, three
    cells at once on the rank pool's workers (:func:`dryrun_start`): the
    main path's (1x1, one SEQ-token sequence, flashcp, remat), whose
    kernel-adjusted peak must lie within DRYRUN_PEAK_RATIO of the train
    phase's measured peak; pod_train's (2x1x2, DP_LAYERS layers,
    DP_BATCH x DP_SEQ), whose ZeRO-3 state bytes must equal each rank's;
    and one production cell, printed with its ``fits``."""
    job, t0 = pending
    recs = {r["cell"]: r for r in job.wait()}
    wall = time.perf_counter() - t0
    main, pod_cell = recs["main_path"], recs["pod_train"]
    predicted = main["memory"]["peak_bytes_kernel_adjusted"]
    ratio = predicted / trained["peak_bytes"]
    pod_pred = pod_cell["memory"]["state_bytes"]
    emit("dryrun", wall_s=wall, trace_s={n: r["trace_s"]
                                         for n, r in recs.items()},
         main_path={"predicted_peak_bytes": predicted,
                    "predicted_peak_bytes_plain_attention":
                        main["memory"]["peak_bytes_per_device"],
                    "measured_peak_bytes": trained["peak_bytes"],
                    "ratio": ratio, "bound": DRYRUN_PEAK_RATIO},
         pod_train={"predicted_state_bytes": pod_pred,
                    "ranks_state_bytes": pod["state_bytes"]},
         records=recs)
    if not 1 / DRYRUN_PEAK_RATIO <= ratio <= DRYRUN_PEAK_RATIO:
        raise AssertionError(f"the dry run's peak {predicted} is {ratio:.3g}"
                             f" x the measured {trained['peak_bytes']}")
    if any(b != pod_pred for b in pod["state_bytes"]):
        raise AssertionError(f"the dry run's ZeRO-3 state {pod_pred} B, the "
                             f"ranks hold {pod['state_bytes']}")
    if any(r["status"] != "ok" for r in recs.values()):
        raise AssertionError("a dry-run cell did not trace")
    return {"ratio": ratio}


# ----------------------------------------------------------------------- #
# the distributed training loop: a data axis, ZeRO-3, checkpoints
# ----------------------------------------------------------------------- #
def dp_train_args(*extra):
    return train_args("--arch", ARCH, "--layers", str(DP_LAYERS),
                      "--seq-len", str(DP_SEQ), "--batch", str(DP_BATCH),
                      "--steps", str(DP_STEPS), "--device", "cuda",
                      "--log-every", "100", *extra)


def smoke_args(*extra):
    """The f32 smoke model on the card (checkpoint resharding check)."""
    return train_args("--smoke", "--seq-len", "512", "--batch", "2",
                      "--device", "cuda", "--log-every", "100", *extra)


def resume_check(backend, ckpt_dir: str, dev) -> dict:
    """On this rank of a 4-rank world: the smoke model trained
    DP_RESUME_STEPS steps on a 2x2 mesh without a stop, and again with a
    stop after step DP_RESUME_AT (its final checkpoint) and a resume on a
    1x4 mesh; each run's losses."""
    from repro_torch.launch.mesh import make_local_mesh

    m22 = make_local_mesh(2, 2, device_type="cuda")
    m14 = make_local_mesh(1, 4, device_type="cuda")
    steps = str(DP_RESUME_STEPS)
    kw = ("--dist-backend", backend)
    whole = train(smoke_args("--mesh", "2x2", "--steps", steps, *kw),
                  mesh=m22, device=dev)["losses"]
    first = train(smoke_args("--mesh", "2x2", "--steps", str(DP_RESUME_AT),
                             "--checkpoint-dir", ckpt_dir, *kw),
                  mesh=m22, device=dev)["losses"]
    resumed = train(smoke_args("--mesh", "1x4", "--steps", steps,
                               "--checkpoint-dir", ckpt_dir, "--resume",
                               *kw), mesh=m14, device=dev)["losses"]
    return {"uninterrupted_2x2": whole, "stopped_2x2": first,
            "resumed_1x4": resumed}


def restore_check(res, ckpt_dir: str, mesh, backend, dev) -> dict:
    """This rank's shards of ``train``'s final checkpoint in ``ckpt_dir``,
    restored on ``mesh``: whether they equal the shards ``res`` ended
    with, bit for bit, and the device's peak memory over the restore
    beside this rank's state bytes and the whole checkpoint's."""
    import math
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import restore_state
    from repro_torch.runtime.zero import named_leaves

    ckpt = CheckpointManager(ckpt_dir)
    step = ckpt.latest_step()
    whole = sum(math.prod(a["shape"]) * (2 if a["dtype"] == "bfloat16"
                                         else np.dtype(a["dtype"]).itemsize)
                for a in ckpt.manifest(step)["arrays"].values())
    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt, _ = restore_state(ckpt, step, mesh, backend, dev)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    got = named_leaves({"params": params, "opt": opt})
    want = named_leaves({"params": res["params"], "opt": res["opt_state"]})
    return {"step": step, "seconds": seconds, "peak_bytes": peak,
            "state_bytes": sum(x.numel() * x.element_size() for _, x in got),
            "checkpoint_bytes": whole,
            "equal": [p for p, _ in got] == [p for p, _ in want]
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))}


def dp_train_rank(rank, world, backend, store, out_dir, grad_dir, ckpt_dir,
                  full_ckpt_dir):
    """One rank of the 2x2 training run: step 0's gradients (rank 0 saves
    them whole to ``grad_dir``), ``train`` with the launch counts read
    around it and its final checkpoint in ``full_ckpt_dir``, its ZeRO-3
    state, the restore of that checkpoint; then the checkpoint resharding
    check."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank
    from repro_torch.models import init_params

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(*DP_MESH, device_type="cuda")
        _, grads = step0_grads("bfloat16", mesh, dev, backend,
                               layers=DP_LAYERS, seq=DP_SEQ, batch=DP_BATCH)
        if rank == 0:
            torch.save(grads, Path(grad_dir) / "grads.pt")
        del grads
        cfg = dataclasses.replace(get_config(ARCH), num_layers=DP_LAYERS)
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = train(dp_train_args("--mesh", "x".join(map(str, DP_MESH)),
                                  "--dist-backend", backend,
                                  "--checkpoint-dir", full_ckpt_dir),
                    params=params, mesh=mesh, device=dev)
        launches = read_counts()
        out = {"rank": rank, "losses": res["losses"],
               "grad_norms": res["grad_norms"], "step_s": res["step_s"],
               "tokens": res["tokens"],
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               **zero_state(res), "launches": launches}
        del params
        out["restore"] = restore_check(res, full_ckpt_dir, mesh, backend, dev)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        out["resume"] = resume_check(backend, ckpt_dir, dev)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_train_phase(torch, one) -> dict:
    """Full-width starcoder2_3b cut to DP_LAYERS layers, bf16 with an
    fp32 master, flashcp, on a 2x2 mesh (ZeRO-3 over both axes, the rows
    of a 2 x 16384-token batch over ``data``, each row's tokens over
    ``model``) for DP_STEPS steps, against one rank on the same global
    batch from the same parameters: step 0's loss (DP_LOSS_TOL), grad
    norm and every gradient leaf but the embedding table (DP_TOL); every
    loss finite; every rank's launches exactly layers x steps x (1 + 1
    hop) x (2, 1, 1); the ZeRO-3 state as in ``cp_train``; the final
    checkpoint restored on 2x2: every rank's shards bit for bit, the
    device's peak over the restore at the rank's state size (within
    DP_RESTORE_SLACK).  Then the smoke model, f32 on the card: a checkpoint written at step
    DP_RESUME_AT on 2x2 and resumed on 1x4 reaches the uninterrupted
    run's losses (DP_RESUME_TOL).  ``one`` is the one-rank step 0
    (loss, {leaf: grad}, seconds), which ``cp_train`` made for
    ``pod_train``."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    world = math.prod(DP_MESH)
    loss1, g1, one_s = one
    gnorm1 = math.sqrt(sum(g.double().pow(2).sum().item()
                           for g in g1.values()))
    cfg = dataclasses.replace(get_config(ARCH), num_layers=DP_LAYERS)
    want_bytes = expected_state_bytes(
        init_params(cfg, seed=0, device="cuda"), DP_MESH)
    gc.collect()
    torch.cuda.empty_cache()

    backend = cp_backend(torch, world)
    with tempfile.TemporaryDirectory() as tmp:
        grad_dir, ckpt_dir = Path(tmp) / "grads", Path(tmp) / "ckpt"
        grad_dir.mkdir()
        t0 = time.perf_counter()
        ranks = run_ranks(torch, dp_train_rank, world, str(grad_dir),
                          str(ckpt_dir), str(Path(tmp) / "ckpt_full"))
        wall = time.perf_counter() - t0
        leaf = compare_grads(torch.load(grad_dir / "grads.pt"), g1)
    del g1
    r0 = ranks[0]
    d_loss = abs(r0["losses"][0] - loss1) / abs(loss1)
    d_norm = abs(r0["grad_norms"][0] - gnorm1) / gnorm1
    gated = [r for r in leaf["leaves"] if r["leaf"] != EMBED_LEAF]
    embed = next(r for r in leaf["leaves"] if r["leaf"] == EMBED_LEAF)
    hops = DP_MESH[1] - 1
    want = {n: DP_LAYERS * DP_STEPS * (1 + hops) * k
            for n, k in (("flash_fwd", 2), ("flash_bwd_dq", 1),
                         ("flash_bwd_dkv", 1))}
    tokens = DP_SEQ * DP_BATCH
    per_rank = []
    for x in ranks:
        step_s = statistics.mean(x["step_s"][1:])
        per_rank.append({k: x[k] for k in (
            "rank", "losses", "grad_norms", "step_s", "peak_bytes",
            "shapes_ok", "state_bytes", "launches", "restore")}
            | {"step_s_after_first": step_s, "tokens_per_s": tokens / step_s})
    res = r0["resume"]
    d_resume = max(abs(a - b) / abs(b) for a, b in zip(
        res["resumed_1x4"], res["uninterrupted_2x2"][DP_RESUME_AT:]))
    emit("dp_train", arch=ARCH, layers=DP_LAYERS, mesh=list(DP_MESH),
         backend=backend,
         exchange=("gloo through host memory, not NVLink"
                   if backend == "gloo" else "nccl"),
         seq_len=DP_SEQ, batch=DP_BATCH, tokens_per_rank=tokens // world,
         steps=DP_STEPS,
         one_rank_step0={"loss": loss1, "grad_norm": gnorm1,
                         "seconds": one_s},
         loss_rel_diff=d_loss, loss_tol=DP_LOSS_TOL,
         grad_norm_rel_diff=d_norm, tol=DP_TOL,
         grad_rel_err=leaf["grad_rel_err"], worst_leaves=gated[:6],
         embed_leaf=embed, embed_leaf_not_gated=F2,
         expected_launches=want, expected_state_bytes=want_bytes,
         wall_s=wall, ranks=per_rank, resume=res,
         resume_rel_diff=d_resume, resume_tol=DP_RESUME_TOL)
    finite = all(math.isfinite(v) for x in ranks
                 for v in x["losses"] + x["grad_norms"])
    if not finite:
        raise AssertionError("2x2 training produced non-finite losses")
    if not (d_loss <= DP_LOSS_TOL and d_norm <= DP_TOL):
        raise AssertionError("2x2 and one-rank training steps disagree")
    if gated[0]["rel_err"] > DP_TOL:
        raise AssertionError(f"2x2 step-0 gradient of {gated[0]['leaf']} is "
                             f"{gated[0]['rel_err']:.3g} from one rank's")
    check_zero_state("2x2 training", ranks, want_bytes)
    if any(x["launches"][n] != want[n] for x in ranks for n in want):
        raise AssertionError(f"2x2 training launches "
                             f"{[x['launches'] for x in ranks]}, want {want} "
                             "per rank")
    for x in ranks:
        r = x["restore"]
        if not (r["equal"] and r["step"] == DP_STEPS
                and r["state_bytes"] == x["state_bytes"]):
            raise AssertionError(f"rank {x['rank']}: the restored 2x2 "
                                 f"shards differ from the saved ones: {r}")
        if r["peak_bytes"] > r["state_bytes"] + DP_RESTORE_SLACK:
            raise AssertionError(
                f"rank {x['rank']}: restoring took {r['peak_bytes']} bytes "
                f"of the device for a shard state of {r['state_bytes']} "
                f"(the whole checkpoint: {r['checkpoint_bytes']})")
    if any(x["resume"] != res for x in ranks):
        raise AssertionError("the ranks logged other resumed losses")
    if len(res["resumed_1x4"]) != DP_RESUME_STEPS - DP_RESUME_AT \
            or d_resume > DP_RESUME_TOL:
        raise AssertionError(f"2x2 -> 1x4 resume: {res}")
    return {"ranks": per_rank}


def dp_full_rank(rank, world, backend, store, out_dir):
    """One rank of the full-depth 2x1 run: one step of ``train`` with the
    launch counts and peak memory read around it, and its state."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(*DP_FULL_MESH, device_type="cuda")
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = train(train_args(
            "--arch", ARCH, "--seq-len", str(DP_FULL_SEQ), "--batch",
            str(DP_FULL_BATCH), "--steps", "1", "--device", "cuda",
            "--log-every", "100", "--mesh", "x".join(map(str, DP_FULL_MESH)),
            "--dist-backend", backend), mesh=mesh, device=dev)
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "losses": res["losses"],
                       "grad_norms": res["grad_norms"],
                       "step_s": res["step_s"], "wall_s": wall,
                       "peak_bytes": torch.cuda.max_memory_allocated(dev),
                       **zero_state(res), "launches": launches}, f)
    finally:
        dist.destroy_process_group()


def dp_full_phase(torch) -> dict:
    """All 30 layers of full-width starcoder2_3b (3.18 B parameters), bf16
    with an fp32 master, on a 2x1 mesh: ZeRO-3 lets two ranks' state
    share one card (two replicas would not fit).  One step of a 2 x
    8192-token batch, one row per rank; then, after the ranks exit, one
    rank's step-0 loss and grad norm on the same batch: loss within
    DP_LOSS_TOL, grad norm within DP_TOL; the ZeRO-3 state as in
    ``cp_train``; launches exactly 30 x (2, 1, 1) per rank.  Each rank's
    peak memory."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    world = math.prod(DP_FULL_MESH)
    backend = cp_backend(torch, world)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, dp_full_rank, world)
    wall = time.perf_counter() - t0

    cfg = get_config(ARCH)
    want_bytes = expected_state_bytes(init_params(cfg, seed=0, device="cuda"),
                                      DP_FULL_MESH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    loss, norm = step0_grads("bfloat16", layers=cfg.num_layers,
                             seq=DP_FULL_SEQ, batch=DP_FULL_BATCH,
                             norm_only=True)
    one = {"loss": loss, "grad_norm": norm,
           "seconds": time.perf_counter() - t1,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    gc.collect()
    torch.cuda.empty_cache()
    r0 = ranks[0]
    d_loss = abs(r0["losses"][0] - one["loss"]) / abs(one["loss"])
    d_norm = abs(r0["grad_norms"][0] - one["grad_norm"]) / one["grad_norm"]
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    emit("dp_full", arch=ARCH, params=cfg.param_count(), layers=L,
         mesh=list(DP_FULL_MESH), backend=backend,
         exchange=("gloo through host memory, not NVLink"
                   if backend == "gloo" else "nccl"),
         seq_len=DP_FULL_SEQ, batch=DP_FULL_BATCH, steps=1,
         tokens_per_s=DP_FULL_SEQ * DP_FULL_BATCH / r0["step_s"][0],
         one_rank_step0=one, loss_rel_diff=d_loss, loss_tol=DP_LOSS_TOL,
         grad_norm_rel_diff=d_norm, tol=DP_TOL, expected_launches=want,
         expected_state_bytes=want_bytes, wall_s=wall, ranks=ranks)
    if not all(math.isfinite(v) for x in ranks
               for v in x["losses"] + x["grad_norms"]):
        raise AssertionError("2x1 training produced non-finite losses")
    if not (d_loss <= DP_LOSS_TOL and d_norm <= DP_TOL):
        raise AssertionError("2x1 and one-rank full-depth steps disagree")
    check_zero_state("2x1 training", ranks, want_bytes)
    if any(x["launches"][n] != want[n] for x in ranks for n in want):
        raise AssertionError(f"2x1 training launches "
                             f"{[x['launches'] for x in ranks]}, want {want} "
                             "per rank")
    return {"ranks": ranks}


# ----------------------------------------------------------------------- #
# serving: chaos quarantine, snapshot / kill / restore, sharded decode
# ----------------------------------------------------------------------- #
def serve_resilience_phase(torch, serving) -> dict:
    """Full-width starcoder2_3b, paged, the main path's 12 requests on 6
    slots, under chaos: one request poisoned (NaN logits) in its decode,
    one poisoned from step 0 (it fires at its final prefill chunk), one
    stuck in its decode (the watchdog aborts it after RES_PATIENCE
    planned steps without progress), one latency spike, and a kill,
    with snapshots every RES_SNAPSHOT_EVERY steps, restored into a fresh
    engine that finishes the run.  Gates: every request ends; exactly
    the poisoned and stuck ones are aborted, with their reasons; every
    healthy request's greedy tokens equal the main path's uninjected
    run's; no block of the prefill-poisoned prompt (past the shared
    prefix) is in the prefix trie.  Prints the snapshot's bytes and its
    save and restore seconds."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.serve import ChaosInjector, EngineKilled, ServeEngine

    cfg = get_config("starcoder2_3b")
    base = serving["paged"]["eng"]
    clean = {r: e["tokens"] for r, e in base.sched.finished.items()}
    # the step at which each request of the clean run ended (all were
    # submitted at step 0)
    done = {r: e["latency_steps"] for r, e in base.sched.finished.items()}
    prompts = requests(cfg)
    gen = 32
    # decode faults land 10 and 20 steps before the request's clean end,
    # inside its 32 decode steps; the kill after both have been handled
    nan_rid, stuck_rid, pre_rid = 1, 3, 5
    nan_at, stuck_at = done[nan_rid] - 10, done[stuck_rid] - 20
    kill_at = max(nan_at, stuck_at + RES_PATIENCE) + 4
    chaos = ChaosInjector(nan_logits={nan_rid: nan_at, pre_rid: 0},
                          stuck={stuck_rid: stuck_at},
                          delays={RES_DELAY_STEP: RES_DELAY_S},
                          kill_at=kill_at)

    def engine():
        eng = ServeEngine(cfg, base.params, device="cuda", kv_layout="paged",
                          max_len=base.max_len, num_slots=6,
                          prefill_chunk=128, block_size=16,
                          stall_patience=RES_PATIENCE, chaos=chaos)
        eng.warmup()
        for p in prompts:
            eng.submit(p, max_new=gen)
        return eng

    with tempfile.TemporaryDirectory() as tmp:
        snap = f"{tmp}/snap"
        eng = engine()
        t0 = time.perf_counter()
        try:
            eng.run(snapshot_every=RES_SNAPSHOT_EVERY, snapshot_dir=snap)
            raise AssertionError(f"the kill at step {kill_at} never fired")
        except EngineKilled:
            pass
        killed_s = time.perf_counter() - t0
        killed_steps = eng.stats["steps"]
        snaps = eng.stats["snapshots"]
        # one more snapshot of the killed engine, timed
        t0 = time.perf_counter()
        step = eng.snapshot(f"{tmp}/timed")
        save_s = time.perf_counter() - t0
        snap_bytes = sum(f.stat().st_size for f in
                         Path(f"{tmp}/timed/step_{step:09d}").iterdir())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        # a fresh engine of the same geometry (the same injector: its kill
        # has fired, and its step-keyed faults hold after the restore)
        fresh = ServeEngine(cfg, base.params, device="cuda",
                            kv_layout="paged", max_len=base.max_len,
                            num_slots=6, prefill_chunk=128, block_size=16,
                            stall_patience=RES_PATIENCE, chaos=chaos)
        fresh.warmup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = fresh.restore_snapshot(snap)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fresh.run()
        resumed_s = time.perf_counter() - t0
    aborted = {r: e.get("reason") for r, e in res.items()
               if e["status"] != "ok"}
    healthy = [r for r in res if r not in (nan_rid, stuck_rid, pre_rid)]
    same = [r for r in healthy
            if res[r]["status"] == "ok" and len(res[r]["tokens"]) == gen
            and (res[r]["tokens"] == clean[r]).all()]
    # the prefill-poisoned prompt's own full blocks (past the shared
    # prefix) must not be in the trie
    bs = fresh.block_size
    own = {tuple(int(t) for t in prompts[pre_rid][i:i + bs])
           for i in range(128, len(prompts[pre_rid]) - bs + 1, bs)}
    trie = {tuple(key[1]) for key in fresh.prefix._by_key}
    leaked = len(own & trie)
    emit("serve_resilience", arch=cfg.name, requests=len(prompts),
         chaos={"nan_decode": [nan_rid, nan_at],
                "nan_prefill": [pre_rid, 0], "stuck": [stuck_rid, stuck_at],
                "delay": [RES_DELAY_STEP, RES_DELAY_S], "kill_at": kill_at},
         stall_patience=RES_PATIENCE, snapshot_every=RES_SNAPSHOT_EVERY,
         killed_at_step=killed_steps, snapshots_before_kill=snaps,
         restored_step=restored, killed_run_s=killed_s,
         resumed_run_s=resumed_s, snapshot_bytes=snap_bytes,
         snapshot_save_s=save_s, snapshot_restore_s=restore_s,
         chaos_delay_s=fresh.stats["chaos_delay_s"],
         statuses={r: e["status"] for r, e in res.items()},
         aborted=aborted, healthy_same_tokens=len(same),
         healthy=len(healthy), poisoned_blocks_in_trie=leaked)
    if sorted(res) != list(range(len(prompts))):
        raise AssertionError(f"requests lost: {sorted(res)}")
    reasons = {nan_rid: "non-finite decode", pre_rid: "non-finite prefill",
               stuck_rid: "no scheduler progress"}
    if set(aborted) != set(reasons) or any(
            reasons[r] not in (aborted[r] or "") for r in reasons):
        raise AssertionError(f"aborted {aborted}, want {reasons}")
    if len(same) != len(healthy):
        raise AssertionError(f"healthy requests with other tokens than the "
                             f"uninjected run's: "
                             f"{sorted(set(healthy) - set(same))}")
    if leaked:
        raise AssertionError(f"{leaked} poisoned blocks in the prefix trie")
    if restored <= 0 or restored >= kill_at:
        raise AssertionError(f"restored step {restored}, kill at {kill_at}")
    return {"snapshot_bytes": snap_bytes}


def serve_sharded_phase(torch, serving) -> dict:
    """The dense layout at ``attn_shards`` 2 and 4 (each stripe split into
    that many segments, one ``flash_decode`` partial each, LSE-merged) on
    the main path's requests, full-width starcoder2_3b.  In bf16, the
    model's own dtype, one decode step's logits at each shard count
    within DECODE_STEP_BF16_TOL of the largest of one shard's (the
    segments' other accumulation order moves a rounding of the attention
    output, as the flash kernel does against the dense oracle).  Random
    weights leave near-tied logits that such a rounding flips, so the
    served runs are gated in f32: greedy tokens equal to the one-shard
    run's, and ``flash_decode`` launched decode steps x 30 x shards
    times."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step

    cfg = get_config("starcoder2_3b")
    base = serving["dense"]["eng"]
    # bf16: one decode step from the main path's dense cache
    toks = torch.arange(6, device="cuda") * 1000 + 7
    pos = torch.tensor([255, 400, 600, 800, 1000, 1054], dtype=torch.int32,
                       device="cuda")
    logits = {}
    for shards in (1, *SHARDS):
        cache = {j: {n: t.clone() for n, t in sub.items()}
                 for j, sub in base.cache.items()}
        logits[shards] = decode_step(base.params, cfg, cache,
                                     {"tokens": toks}, pos,
                                     attn_shards=shards)[0].float()
        del cache
    scale = logits[1].abs().max().item()
    step = {s: (logits[s] - logits[1]).abs().max().item() for s in SHARDS}
    emit("serve_sharded_bf16_step", max_abs_diff=step, max_abs_logit=scale,
         limit=DECODE_STEP_BF16_TOL * scale)
    del logits
    if not max(step.values()) <= DECODE_STEP_BF16_TOL * scale:
        raise AssertionError(f"bf16 decode step at attn_shards {step} "
                             f"from one shard's, over the limit "
                             f"{DECODE_STEP_BF16_TOL * scale}")

    c32 = dataclasses.replace(cfg, dtype="float32")
    params = _widen(base.params)
    prompts = requests(cfg)
    out, tokens = {}, {}
    for shards in (1, *SHARDS):
        eng, res, launches, wall, peak = serve_run(
            torch, c32, params, "dense", prompts, SHARD_GEN, num_slots=6,
            prefill_chunk=128, block_size=16, attn_shards=shards)
        want = eng.stats["decode_steps"] * cfg.num_layers * shards
        tokens[shards] = {r: e["tokens"] for r, e in res.items()}
        same = sum(int((tokens[shards][r] == tokens[1][r]).all())
                   for r in res)
        emit("serve_sharded", arch=cfg.name, dtype="float32",
             attn_shards=shards, kv_layout=eng.layout, wall_s=wall,
             **eng.throughput(), decode_steps=eng.stats["decode_steps"],
             launches=launches, expected_launches=want,
             same_tokens_as_one_shard=same, of=len(prompts),
             peak_bytes=peak)
        if launches["flash_decode"] != want:
            raise AssertionError(f"attn_shards {shards}: flash_decode "
                                 f"launched {launches['flash_decode']} "
                                 f"times, want {want}")
        if same != len(prompts):
            raise AssertionError(f"attn_shards {shards}: {same} of "
                                 f"{len(prompts)} requests have the "
                                 "one-shard run's tokens")
        out[shards] = launches["flash_decode"]
        del eng
    del params
    # the sharded decode across ranks runs in cp_islands' spawn
    out["decode_inputs"] = sharded_decode_inputs(torch, base)
    return out


def sharded_decode_rows(torch, rank, comms, dev, inputs_path) -> list:
    """This rank's part of the sharded decode of
    :func:`sharded_decode_inputs`: for each rank count n in SHARDS (the
    first n ranks, ``comms[n]``) and dtype, its S-slice of the cache and
    per step one ``flash_decode_ranks`` call, its output held against one
    rank's over the whole cache, its launches and seconds."""
    from repro_torch.kernels.flash_decode import (flash_decode_ranks,
                                                  local_lengths)

    inp = torch.load(inputs_path)
    out = []
    for n in SHARDS:
        if comms[n] is None:
            continue
        for name in ("float32", "bfloat16"):
            q = inp[f"{name}/q"].to(dev)
            S_l = inp[f"{name}/k"].shape[2] // n
            ks, vs = (inp[f"{name}/{x}"][:, :, rank * S_l:(rank + 1) * S_l]
                      .contiguous().to(dev) for x in "kv")
            for step, lens in enumerate(inp["lengths"]):
                ln = lens.to(dev)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = flash_decode_ranks(q, ks, vs, ln, comm=comms[n])
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                launches = read_counts()
                want = inp[f"{name}/want{step}"].to(dev).float()
                rel = (o.float() - want).abs().max().item() \
                    / max(want.abs().max().item(), 1e-30)
                out.append({
                    "ranks": n, "rank": rank, "dtype": name, "step": step,
                    "rel_err": rel, "seconds": sec, "launches": launches,
                    "backend": comms[n].backend,
                    "local_lengths": local_lengths(lens, rank * S_l,
                                                   S_l).tolist()})
    return out


def sharded_decode_inputs(torch, base) -> dict:
    """The sharded decode's inputs, on the host: the main path's dense
    cache (layer 0's stripes: B 6, Hkv 2, S the engine's padded to split
    over 4, D 128; q at Hq 24 from a seed) in f32 and bf16, two steps of
    lengths (the main path's with row 0 moved wholly onto the first
    shard, so the other ranks see nothing of it; then every row within
    the first quarter, so the ranks past the first see nothing at all),
    and one rank's normalized ``flash_decode`` over the whole cache for
    each."""
    from repro_torch.kernels.flash_decode import flash_decode

    k0, v0 = base.cache["sub_0"]["k"][0], base.cache["sub_0"]["v"][0]
    world = max(SHARDS)
    pad = -k0.shape[2] % world
    k0, v0 = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k0, v0))
    step0 = torch.tensor([100, 400, 600, 800, 1000, 1054],
                         dtype=torch.int32)
    lengths = [step0, step0 % (k0.shape[2] // world)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q0 = torch.randn((k0.shape[0], HQ, k0.shape[3]), generator=gen,
                     device="cuda")
    inp = {"lengths": lengths}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        q, k, v = (x.to(dtype).contiguous() for x in (q0, k0, v0))
        inp.update({f"{name}/q": q.cpu(), f"{name}/k": k.cpu(),
                    f"{name}/v": v.cpu()})
        for step, lens in enumerate(lengths):
            inp[f"{name}/want{step}"] = flash_decode(
                q, k, v, lens.to("cuda")).cpu()
    return inp


def sharded_decode_report(rows, inputs: dict) -> None:
    """Gate the sharded decode's rows: each rank's output against one
    rank's, f32 within TOL and bf16 within DECODE_STEP_BF16_TOL, relative
    to the largest entry; exactly one ``flash_decode`` launch per rank
    per step; some rank saw nothing of some row."""
    backend = rows[0]["backend"]
    lengths = inputs["lengths"]
    _, hkv, S, d = inputs["float32/k"].shape
    tol = {"float32": TOL["float32"], "bfloat16": DECODE_STEP_BF16_TOL}
    for n in SHARDS:
        for name in ("float32", "bfloat16"):
            mine = [x for x in rows if x["ranks"] == n
                    and x["dtype"] == name]
            err = max(x["rel_err"] for x in mine)
            emit("serve_sharded_ranks", ranks=n, dtype=name,
                 backend=backend, rendezvous="env://",
                 exchange=("gloo through host memory, not NVLink"
                           if backend == "gloo" else "nccl"),
                 heads=[HQ, hkv, d], S=S,
                 lengths=[x.tolist() for x in lengths], rel_err=err,
                 tol=tol[name], rows=mine)
            if err > tol[name]:
                raise AssertionError(f"sharded decode over {n} ranks "
                                     f"({name}) off one rank's by {err}")
            if len(mine) != n * len(lengths) or any(
                    x["launches"]["flash_decode"] != 1 for x in mine):
                raise AssertionError(
                    f"sharded decode over {n} ranks: launches "
                    f"{[x['launches'] for x in mine]}, want one "
                    "flash_decode per rank per step")
    if not any(ln < 0 for x in rows for ln in x["local_lengths"]):
        raise AssertionError("no rank saw nothing of a row")


# ----------------------------------------------------------------------- #
# the MoE family: olmoe_1b_7b served, trained, and over 4 EP/CP ranks
# ----------------------------------------------------------------------- #
class DropCounter:
    """Counts the routed (token, choice) pairs and those the capacity
    drops, by wrapping ``repro_torch.models.moe.dispatch_local`` (the
    local dispatch and the EP island both call it), for the calls over
    ``rows`` tokens (None: every call).  The counts stay on the device
    until read."""

    def __init__(self, rows=None):
        self.rows, self.pairs, self.kept = rows, 0, None

    def __enter__(self):
        import repro_torch.models.moe as moe
        self.moe, self.orig = moe, moe.dispatch_local

        def counted(xt, topi, gates, num_experts, cap):
            out = self.orig(xt, topi, gates, num_experts, cap)
            if self.rows is None or xt.shape[0] == self.rows:
                keep = out[4]
                self.pairs += keep.numel()
                k = keep.sum()
                self.kept = k if self.kept is None else self.kept + k
            return out

        moe.dispatch_local = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_local = self.orig

    def dropped_share(self):
        if not self.pairs:
            return None
        return 1.0 - int(self.kept) / self.pairs


def moe_smoke_parity(torch) -> None:
    """A small f32 olmoe served on the card and on the CPU (the kernels'
    plain versions), paged and dense: the same greedy tokens."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params

    cfg = reduce_for_smoke(get_config(MOE_ARCH))
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
                raise AssertionError("MoE smoke run launched no kernel")
        same = toks["cuda"] == toks["cpu"]
        emit("moe_smoke_cuda_vs_cpu_tokens", layout=layout, identical=same)
        if not same:
            raise AssertionError(f"MoE {layout}: cuda and cpu tokens differ")


def moe_serve_phase(torch) -> dict:
    """olmoe_1b_7b at full width and full depth (16 layers, 64 experts,
    top-8, bf16, 6.92 B random parameters from a seed) serving the main
    path's 12 requests on 6 slots, paged and dense: every request ok and
    each decode kernel launched decode steps x 16 times; decode tok/s,
    peak memory and the share of routed (token, choice) pairs the decode
    capacity (the config's 1.25 over the 6 rows) drops.  Then one decode
    step of the full model in f32, flash kernel against the dense
    oracle, within MOE_DECODE_TOL of the largest logit (the bf16 step's
    difference printed), and the small f32 model card vs CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params

    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("moe_init", arch=cfg.name, params=cfg.param_count(),
         active_params=cfg.active_param_count(),
         seconds=time.perf_counter() - t0,
         param_bytes=torch.cuda.memory_allocated())
    prompts = requests(cfg)
    gen, L = MOE_GEN, cfg.num_layers
    kw = dict(num_slots=6, prefill_chunk=128, block_size=16)
    out = {}
    for layout, kernel in (("paged", "flash_decode_paged"),
                           ("dense", "flash_decode")):
        with DropCounter(rows=kw["num_slots"]) as drops:
            eng, res, launches, wall, peak = serve_run(
                torch, cfg, params, layout, prompts, gen, **kw)
        s = eng.stats
        want = s["decode_steps"] * L
        emit(f"moe_serve_{layout}", arch=cfg.name, layers=L,
             requests=len(prompts), slots=kw["num_slots"], gen=gen,
             wall_s=wall, **eng.throughput(),
             stats={k: v for k, v in s.items() if not isinstance(v, dict)},
             launches=launches, expected_launches=want, peak_bytes=peak,
             kv_cache_bytes=eng.kv_cache_bytes(),
             decode_capacity_factor=cfg.capacity_factor,
             decode_pairs=drops.pairs,
             decode_dropped_share=drops.dropped_share(),
             latency=eng.latency_percentiles())
        if launches[kernel] != want or not want:
            raise AssertionError(f"MoE {layout}: {kernel} launched "
                                 f"{launches[kernel]} times, want {want}")
        out[layout] = {"launches": launches[kernel],
                       "decode_tok_s": eng.throughput()["decode_tok_s"]}
        if layout == "dense":
            cache = eng.cache
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # one decode step from the dense run's cache, flash vs dense oracle;
    # the last position is the last one the longest request (1024 prompt
    # tokens + gen) wrote
    gen_t = torch.Generator(device="cuda")
    gen_t.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (6,), generator=gen_t,
                         device="cuda")
    pos = torch.tensor([255, 400, 600, 800, 1000, max(map(len, prompts))
                        + gen - 2], dtype=torch.int32, device="cuda")
    diffs = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = params if dtype == "bfloat16" else _widen(params)
        if dtype == "float32":
            del params
            gc.collect()
            torch.cuda.empty_cache()
        logits = {}
        for impl in ("flash", "dense"):
            kv = {j: {n: t.clone().to(getattr(torch, dtype))
                      for n, t in sub.items()} for j, sub in cache.items()}
            logits[impl] = decode_step(p, c, kv, {"tokens": toks}, pos,
                                       attn_impl=impl)[0].float()
            del kv
        diffs[dtype] = {
            "max_abs_diff": (logits["flash"] - logits["dense"]).abs()
            .max().item(), "max_abs_logit": logits["dense"].abs().max()
            .item()}
        del p, logits
        gc.collect()
        torch.cuda.empty_cache()
    del cache
    f32 = diffs["float32"]
    emit("moe_decode_step_flash_vs_dense", gated_dtype="float32",
         tol=MOE_DECODE_TOL, limit=MOE_DECODE_TOL * f32["max_abs_logit"],
         **{k: v for k, v in diffs.items()})
    if not f32["max_abs_diff"] <= MOE_DECODE_TOL * f32["max_abs_logit"]:
        raise AssertionError("MoE flash and dense decode steps disagree")
    moe_smoke_parity(torch)
    return out


def moe_train_args(*extra):
    return train_args("--arch", MOE_ARCH, "--layers", str(MOE_TRAIN_LAYERS),
                      "--seq-len", str(SEQ), "--batch", "1",
                      "--device", "cuda", "--log-every", "100", *extra)


def moe_train_phase(torch) -> dict:
    """olmoe_1b_7b at full width, depth cut to MOE_TRAIN_LAYERS layers
    (its 16 layers of training state, 111 GB, do not fit one card), bf16
    with an fp32 master, one 8192-token wlb_llm sequence a step, flashcp
    at one rank, flat queue, MOE_TRAIN_STEPS steps: finite losses and aux
    losses, launches exactly layers x (2, 1, 1) a step; then step 0's
    batch from the initial parameters through the kernels and through the
    plain attention: loss and grad norm within STEP_LOSS_TOL and
    STEP_GNORM_TOL."""
    import dataclasses
    import math
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import global_norm

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with DropCounter() as drops:
        res = train(moe_train_args("--steps", str(MOE_TRAIN_STEPS)))
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = MOE_TRAIN_LAYERS
    want = {"flash_fwd": MOE_TRAIN_STEPS * L * 2,
            "flash_bwd_dq": MOE_TRAIN_STEPS * L,
            "flash_bwd_dkv": MOE_TRAIN_STEPS * L}
    mean_s = statistics.mean(res["step_s"][1:])
    out = {"arch": MOE_ARCH, "layers": L, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "seq_len": SEQ,
           "steps": MOE_TRAIN_STEPS, "wall_s": wall,
           "losses": res["losses"], "auxes": res["auxes"],
           "grad_norms": res["grad_norms"], "step_s": res["step_s"],
           "step_s_after_first": mean_s, "tokens_per_s": SEQ / mean_s,
           "peak_bytes": peak, "launches": launches,
           "expected_launches": want,
           "dropped_share": drops.dropped_share()}
    pipe = res["pipeline"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    batch = batch_to_device(make_batch(pipe, 0), "cuda")
    got = {}
    for impl in ("flash", "plain"):
        run = RunConfig(arch=MOE_ARCH, cp_strategy="flashcp",
                        attention_impl=impl, kernel_grid="flat", seed=0)
        fn = build_train_step(cfg, run, q_chunk=512, device="cuda")
        (loss, _), grads = fn.loss_and_grads(params, batch)
        got[impl] = {"loss": float(loss), "grad_norm": float(
            global_norm(grads))}
        del grads
        torch.cuda.empty_cache()
    d_loss = abs(got["flash"]["loss"] - got["plain"]["loss"]) \
        / abs(got["plain"]["loss"])
    d_norm = abs(got["flash"]["grad_norm"] - got["plain"]["grad_norm"]) \
        / got["plain"]["grad_norm"]
    out["step0_flash_vs_plain"] = {**got, "loss_rel_diff": d_loss,
                                   "grad_norm_rel_diff": d_norm,
                                   "loss_tol": STEP_LOSS_TOL,
                                   "grad_norm_tol": STEP_GNORM_TOL}
    emit("moe_train", **out)
    if not all(math.isfinite(x) for x in
               out["losses"] + out["auxes"] + out["grad_norms"]):
        raise AssertionError("MoE training produced non-finite losses")
    if any(launches[n] != want[n] for n in want):
        raise AssertionError(f"MoE training launches {launches}, want "
                             f"{want}")
    if not (d_loss <= STEP_LOSS_TOL and d_norm <= STEP_GNORM_TOL):
        raise AssertionError("MoE flash and plain steps disagree")
    return out


def moe_cp_rank(rank, world, backend, store, out_dir, grad_dir):
    """One rank of the MoE CP runs on a 1xN mesh (ZeRO-3, the experts
    split over ``model``): (a) step 0's f32 gradients at a drop-free
    capacity (rank 0 saves them whole to ``grad_dir``); (b) ``train`` at
    the model's own capacity, its launches, aux losses, dropped share,
    ZeRO-3 state and expert layout."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank
    from repro_torch.runtime.sharding import is_expert_leaf

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(1, world, device_type="cuda")
        t0 = time.perf_counter()
        loss, grads = step0_grads(
            "float32", mesh, dev, backend, layers=MOE_GATE_LAYERS,
            seq=SEQ, arch=MOE_ARCH, cfg_kw=MOE_DROP_FREE)
        gate_s = time.perf_counter() - t0
        if rank == 0:
            torch.save(grads, Path(grad_dir) / "grads.pt")
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  num_layers=MOE_CP_LAYERS)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with DropCounter() as drops:
            res = train(train_args(
                "--arch", MOE_ARCH, "--layers", str(MOE_CP_LAYERS),
                "--seq-len", str(CP_SEQ), "--batch", "1", "--steps",
                str(MOE_CP_STEPS), "--device", "cuda", "--log-every", "100",
                "--mesh", f"1x{world}", "--dist-backend", backend),
                mesh=mesh, device=dev)
        launches = read_counts()
        zero = res["zero"]
        experts = {p: list(zero.specs[p]) for p in zero.paths
                   if is_expert_leaf(p, len(zero.shapes[p]))}
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "gate_loss": loss, "gate_s": gate_s,
                       "losses": res["losses"], "auxes": res["auxes"],
                       "grad_norms": res["grad_norms"],
                       "step_s": res["step_s"],
                       "peak_bytes": torch.cuda.max_memory_allocated(dev),
                       **zero_state(res), "launches": launches,
                       "expert_specs": experts,
                       "dropped_share": drops.dropped_share(),
                       "param_count": cfg.param_count()}, f)
    finally:
        dist.destroy_process_group()


def moe_cp_train_phase(torch) -> dict:
    """olmoe_1b_7b at full width on a 1x4 mesh: ZeRO-3, the experts split
    over ``model`` (16 a rank) and the tokens of each layer's MoE
    exchanged by the EP all-to-all island.  (a) The drop-free gate:
    MOE_GATE_LAYERS layers, f32, capacity factor E / top_k (no rank
    clips, so one rank is the reference), one 8192-token sequence (2048
    a rank): step 0's loss and every gradient leaf against one rank
    within MOE_CP_GATE_TOL.  (b) The model's own run: MOE_CP_LAYERS
    layers, bf16, capacity factor 1.25 (the capacity of each rank's 8192
    tokens), one 32768-token sequence, MOE_CP_STEPS steps: finite losses
    and aux losses, every rank's launches layers x steps x (1 + 3 hops) x
    (2, 1, 1), every rank holding exactly its shards with each expert leaf
    split over ``model``, and the state bytes over the ranks one copy
    plus the replicated leaves'."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    world = MOE_CP_WORLD
    t0 = time.perf_counter()
    loss1, g1 = step0_grads("float32", layers=MOE_GATE_LAYERS, seq=SEQ,
                            arch=MOE_ARCH, cfg_kw=MOE_DROP_FREE)
    one_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_CP_LAYERS)
    want_bytes = expected_state_bytes(init_params(cfg, seed=0,
                                                  device="cuda"),
                                      (1, world))
    gc.collect()
    torch.cuda.empty_cache()
    backend = cp_backend(torch, world)
    with tempfile.TemporaryDirectory() as grad_dir:
        t0 = time.perf_counter()
        ranks = run_ranks(torch, moe_cp_rank, world, grad_dir)
        wall = time.perf_counter() - t0
        leaf = compare_grads(torch.load(Path(grad_dir) / "grads.pt"), g1)
    del g1
    r0 = ranks[0]
    d_loss = abs(r0["gate_loss"] - loss1) / abs(loss1)
    want = {n: MOE_CP_LAYERS * MOE_CP_STEPS * world * k
            for n, k in (("flash_fwd", 2), ("flash_bwd_dq", 1),
                         ("flash_bwd_dkv", 1))}
    per_rank = []
    for x in ranks:
        step_s = statistics.mean(x["step_s"][1:])
        per_rank.append({k: x[k] for k in (
            "rank", "losses", "auxes", "grad_norms", "step_s", "peak_bytes",
            "shapes_ok", "state_bytes", "launches", "dropped_share",
            "gate_s")} | {"step_s_after_first": step_s,
                          "tokens_per_s": CP_SEQ / step_s})
    emit("moe_cp_train", arch=MOE_ARCH, world=world, backend=backend,
         exchange=("gloo through host memory, not NVLink"
                   if backend == "gloo" else "nccl"),
         gate={"layers": MOE_GATE_LAYERS, "dtype": "float32",
               "capacity_factor": MOE_DROP_FREE["capacity_factor"],
               "seq_len": SEQ, "tokens_per_rank": SEQ // world,
               "one_rank_loss": loss1, "one_rank_s": one_s,
               "loss_rel_diff": d_loss, "tol": MOE_CP_GATE_TOL,
               "grad_rel_err": leaf["grad_rel_err"],
               "worst_leaves": leaf["leaves"][:6]},
         run={"layers": MOE_CP_LAYERS, "dtype": "bfloat16",
              "capacity_factor": cfg.capacity_factor, "seq_len": CP_SEQ,
              "tokens_per_rank": CP_SEQ // world, "steps": MOE_CP_STEPS,
              "params": cfg.param_count()},
         expert_specs=r0["expert_specs"], expected_launches=want,
         expected_state_bytes=want_bytes, wall_s=wall, ranks=per_rank)
    if not (d_loss <= MOE_CP_GATE_TOL
            and leaf["leaves"][0]["rel_err"] <= MOE_CP_GATE_TOL):
        raise AssertionError(f"MoE CP step 0 against one rank: loss "
                             f"{d_loss:.3g}, worst leaf "
                             f"{leaf['leaves'][0]}")
    if not all(math.isfinite(v) for x in ranks
               for v in x["losses"] + x["auxes"] + x["grad_norms"]):
        raise AssertionError("MoE CP training produced non-finite losses")
    check_zero_state("MoE CP training", ranks, want_bytes)
    if any(len(s) < 2 or s[1] != "model" for x in ranks
           for s in x["expert_specs"].values()) \
            or any(len(x["expert_specs"]) != 3 for x in ranks):
        raise AssertionError(f"expert leaves not split over model: "
                             f"{r0['expert_specs']}")
    if any(x["launches"][n] != want[n] for x in ranks for n in want):
        raise AssertionError(f"MoE CP launches "
                             f"{[x['launches'] for x in ranks]}, want {want} "
                             "per rank")
    return {"ranks": per_rank}


# ----------------------------------------------------------------------- #
# the recurrent families: jamba_v0_1_52b (hybrid) and xlstm_350m (SSM)
# ----------------------------------------------------------------------- #
def rec_cfg(arch: str):
    """The phases' config of ``arch``: jamba cut to one period."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, num_layers=JAMBA_PERIOD)
    return cfg


def rec_requests(cfg):
    """The recurrent serving load: REC_REQUESTS prompts of REC_LO to
    REC_HI tokens, no shared prefix."""
    return requests(cfg, n=REC_REQUESTS, lo=REC_LO, hi=REC_HI, prefix=0,
                    seed=6)


def attn_layers(cfg) -> int:
    from repro_torch.models import block_kinds, period_length
    return sum(m == "attn" for m, _ in block_kinds(cfg)) \
        * (cfg.num_layers // period_length(cfg))


def gqa_decode_parity(torch) -> dict:
    """``flash_decode`` at jamba's heads (Hq 32 over Hkv 8, D 128), the
    serving batch of 6 rows, against its plain version: f32 and bf16."""
    from repro_torch.kernels.flash_decode import (decode_reference,
                                                  flash_decode)
    gen = torch.Generator(device="cuda").manual_seed(21)
    S = REC_HI + REC_GEN
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn((REC_SLOTS, 32, 128), generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn((REC_SLOTS, 8, S, 128), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        lengths = torch.tensor([-1, 0, 47, 63, 95, S - 1], dtype=torch.int32,
                               device="cuda")
        got = flash_decode(q, k, v, lengths).float()
        want = decode_reference(q.float(), k.float(), v.float(), lengths)
        out[dtype] = {"max_abs_err": (got - want).abs().max().item(),
                      "tol": TOL[dtype]}
    emit("jamba_decode_kernel_gqa", heads="32/8", **out)
    if any(e["max_abs_err"] > e["tol"] for e in out.values()):
        raise AssertionError(f"flash_decode at Hq 32 / Hkv 8: {out}")
    return out


def replay_vs_forward(torch, cfg) -> dict:
    """f32, drop-free: each request's replayed last-token logits (the
    engine's own replay, B slot rows) against the training forward over
    its prompt, within REPLAY_TOL of the largest logit."""
    import dataclasses
    from repro_torch.models import forward, init_params, make_local_context
    from repro_torch.models.transformer import drop_free_capacity
    from repro_torch.optim._slices import leaves
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(cfg, dtype="float32",
                              capacity_factor=drop_free_capacity(cfg))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = rec_requests(cfg)
    eng = ServeEngine(cfg, params, device="cuda", kv_layout="dense",
                      num_slots=REC_SLOTS, max_len=REC_HI + 1,
                      prefill_chunk=64)
    rows, first = {}, eng._first_token

    def grab(req, row):
        rows[req.rid] = row.float().clone()
        return first(req, row)

    eng._first_token = grab
    for p in prompts:
        eng.submit(p, max_new=1)
    res = eng.run()
    if any(e["status"] != "ok" for e in res.values()):
        raise AssertionError(f"f32 replay: {res}")
    worst = []
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            T = len(p)
            pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
            ctx = make_local_context(torch.zeros_like(pos), pos)
            logits, _ = forward(params, cfg, ctx, {"tokens": torch.as_tensor(
                p, dtype=torch.long, device="cuda")[None]}, remat=False)
            ref = logits[0, -1].float()
            worst.append({"rid": rid, "prompt_len": T,
                          "max_abs_diff": (rows[rid] - ref).abs().max()
                          .item(), "max_abs_logit": ref.abs().max().item()})
    out = {"dtype": "float32", "capacity_factor": cfg.capacity_factor,
           "param_bytes": sum(t.numel() * 4 for t in leaves(params)),
           "init_s": init_s, "replay_steps": eng.stats["prefill_decode_steps"],
           "tol": REPLAY_TOL, "requests": worst}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    emit("jamba_replay_vs_forward", card=card_line(), **out)
    bad = [w for w in worst
           if not w["max_abs_diff"] <= REPLAY_TOL * w["max_abs_logit"]]
    if bad:
        raise AssertionError(f"replayed logits vs forward: {bad}")
    return out


def jamba_serve_phase(torch) -> dict:
    """jamba_v0_1_52b at full width, one period (8 layers: 7 Mamba, 1
    attention, 4 MoE of 16 experts; 13.30 B parameters, bf16, random from
    a seed), dense layout: REC_REQUESTS requests of REC_LO-REC_HI tokens
    on REC_SLOTS slots, REC_GEN greedy tokens each, every prompt replayed
    through the decode step at admission.  Gates: every request ok,
    ``flash_decode`` launched exactly (replay + decode steps) x 1
    attention layer times and no other kernel, the kernel against its
    plain version at Hq 32 / Hkv 8, and in f32 (the bf16 model freed
    first) the replayed logits against the training forward."""
    from repro_torch.models import init_params

    cfg = rec_cfg(JAMBA)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit("jamba_init", arch=cfg.name, layers=cfg.num_layers,
         params=cfg.param_count(), active_params=cfg.active_param_count(),
         seconds=time.perf_counter() - t0,
         param_bytes=torch.cuda.memory_allocated())
    prompts = rec_requests(cfg)
    eng, res, launches, wall, peak = serve_run(
        torch, cfg, params, "dense", prompts, REC_GEN, num_slots=REC_SLOTS,
        prefill_chunk=64)
    s = eng.stats
    want = (s["prefill_decode_steps"] + s["decode_steps"]) * attn_layers(cfg)
    # every decode step reads every expert of the 4 MoE layers (the 6 rows
    # route to all 16) besides the Mamba and attention weights
    moe_bytes = sum(t.numel() * t.element_size()
                    for n, t in named(params) if "/moe/w" in n)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "requests": len(prompts), "slots": REC_SLOTS, "gen": REC_GEN,
           "prompt_lens": [len(p) for p in prompts], "wall_s": wall,
           **eng.throughput(),
           "stats": {k: v for k, v in s.items() if not isinstance(v, dict)},
           "launches": launches, "expected_flash_decode": want,
           "peak_bytes": peak, "kv_cache_bytes": eng.kv_cache_bytes(),
           "moe_expert_bytes": moe_bytes,
           "decode_step_bound_ms_moe_bytes": moe_bytes / HBM_BYTES_PER_S
           * 1e3,
           "decode_step_ms": s["decode_s"] / max(s["decode_steps"], 1) * 1e3,
           "latency": eng.latency_percentiles()}
    emit("jamba_serve", card=card_line(), **out)
    if launches["flash_decode"] != want or not want or any(
            n != "flash_decode" and c for n, c in launches.items()):
        raise AssertionError(f"jamba serving launches {launches}, want "
                             f"flash_decode {want}")
    del eng, res, params
    gc.collect()
    torch.cuda.empty_cache()
    gqa_decode_parity(torch)
    out["replay_vs_forward"] = replay_vs_forward(torch, cfg)
    return out


def sequential_selective_scan(torch, dt, A, Bm, Cm, xf, reset):
    """The selective scan as a plain token-by-token f32 recurrence."""
    B_, T, di = dt.shape
    h = torch.zeros((B_, di, A.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = torch.empty((B_, T, di), dtype=torch.float32, device=dt.device)
    A = A.float()
    for t in range(T):
        a = torch.exp(dt[:, t, :, None] * A) * reset[:, t, None, None]
        h = a * h + (dt[:, t] * xf[:, t])[..., None] * Bm[:, t, None, :]
        ys[:, t] = torch.einsum("bds,bs->bd", h, Cm[:, t])
    return ys


def time_fb(torch, fn, reps: int = 3) -> tuple:
    """(forward ms, forward + backward ms) of ``fn()`` -> (out, [inputs
    requiring grad], cotangent), by CUDA events, median of ``reps``."""
    fwd, both = [], []
    for _ in range(reps + 1):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        e0.record()
        out, wrt, w = fn()
        e1.record()
        torch.autograd.grad(out, wrt, w)
        e2.record()
        e2.synchronize()
        fwd.append(e0.elapsed_time(e1))
        both.append(e0.elapsed_time(e2))
    return statistics.median(fwd[1:]), statistics.median(both[1:])


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def jamba_mamba_layer(torch, batch) -> dict:
    """One full-width Mamba sublayer (d 4096, d_inner 8192, d_state 16,
    dt_rank 256) on one 8192-token sequence, bf16: forward and backward
    timed, and the selective scan alone; the forward in bf16 and in f32
    against a sequential f32 recurrence."""
    import dataclasses
    from repro_torch.models.context import (ExecContext,
                                            local_selective_scan,
                                            make_local_context)
    from repro_torch.models.layers import he_normal
    from repro_torch.models.ssm import mamba_apply, mamba_init

    cfg = rec_cfg(JAMBA)
    d, S = cfg.d_model, cfg.mamba_d_state
    gen = torch.Generator(device="cuda").manual_seed(31)
    p = mamba_init(lambda shape, fan: he_normal(shape, fan, generator=gen,
                                                device="cuda")[None],
                   d, periods=1, expand=cfg.mamba_expand, d_state=S,
                   d_conv=cfg.mamba_d_conv, dtype=torch.bfloat16,
                   device="cuda")
    p = {k: v[0].to(torch.bfloat16).clone().requires_grad_(True)
         for k, v in p.items()}
    doc = torch.as_tensor(batch["doc"], device="cuda")
    pos = torch.as_tensor(batch["pos"], device="cuda")
    T = pos.shape[1]
    x = torch.randn((1, T, d), generator=gen, device="cuda") \
        .to(torch.bfloat16).requires_grad_(True)
    w = torch.randn((1, T, d), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    ctx = make_local_context(doc, pos)
    kw = dict(d_state=S, d_conv=cfg.mamba_d_conv)
    captured = []

    def capture(*args):
        captured.append(args)
        return local_selective_scan(*args)

    cap_ctx = dataclasses.replace(ctx, selective_scan=capture)
    with torch.no_grad():
        y = mamba_apply(p, x, cap_ctx, **kw)
    scan_in = [a.detach().clone() for a in captured[0]]
    del captured
    fwd_ms, fb_ms = time_fb(
        torch, lambda: (mamba_apply(p, x, ctx, **kw), [x, *p.values()], w))

    def scan_call():
        ins = [a.clone().requires_grad_(i in (0, 2, 3, 4))
               for i, a in enumerate(scan_in)]
        out = local_selective_scan(*ins)
        return out, [ins[i] for i in (0, 2, 3, 4)], torch.ones_like(out)
    scan_fwd_ms, scan_fb_ms = time_fb(torch, scan_call)
    del scan_in
    # the forward against a sequential f32 recurrence
    seq_ctx = ExecContext(doc=doc, pos=pos, attn=None,
                          selective_scan=lambda *a:
                          sequential_selective_scan(torch, *a))
    p32 = {k: v.detach().float() for k, v in p.items()}
    x32 = x.detach().float()
    t0 = time.perf_counter()
    with torch.no_grad():
        y_seq = mamba_apply(p32, x32, seq_ctx, **kw)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        y32 = mamba_apply(p32, x32, ctx, **kw)
    err = {"float32": _rel(y32, y_seq), "bfloat16": _rel(y, y_seq)}
    out = {"shape": {"tokens": T, "d_model": d, "d_inner": d *
                     cfg.mamba_expand, "d_state": S,
                     "dt_rank": p["dt_proj"].shape[0]},
           "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms,
           "scan_fwd_ms": scan_fwd_ms, "scan_fwd_bwd_ms": scan_fb_ms,
           "scan_share_of_fwd_bwd": scan_fb_ms / fb_ms,
           "sequential_f32_s": seq_s, "rel_err_vs_sequential": err,
           "tol": MAMBA_SEQ_TOL}
    emit("jamba_mamba_layer", card=card_line(), **out)
    if any(err[k] > MAMBA_SEQ_TOL[k] for k in err):
        raise AssertionError(f"Mamba sublayer vs the sequential recurrence: "
                             f"{err}")
    return out


def jamba_attn_layer(torch, batch) -> dict:
    """One full-width attention sublayer of jamba (Hq 32 over Hkv 8, D
    128; bf16) on the same sequence through the three doc kernels (flat
    queue), forward and backward, against the plain attention: output
    and every gradient within DOC_TOL of their largest entry, and each
    doc kernel launched once."""
    from repro_torch.kernels.doc_attention import build_block_tables
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.context import ExecContext
    from repro_torch.models.layers import he_normal

    cfg = rec_cfg(JAMBA)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator(device="cuda").manual_seed(41)
    p = {n: he_normal(shape, shape[0], generator=gen, device="cuda")
         .to(torch.bfloat16).requires_grad_(True)
         for n, shape in (("wq", (d, hq * hd)), ("wk", (d, hkv * hd)),
                          ("wv", (d, hkv * hd)), ("wo", (hq * hd, d)))}
    doc = torch.as_tensor(batch["doc"], device="cuda")
    pos = torch.as_tensor(batch["pos"], device="cuda")
    T = pos.shape[1]
    x = torch.randn((1, T, d), generator=gen, device="cuda") \
        .to(torch.bfloat16).requires_grad_(True)
    w = torch.randn((1, T, d), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    tabs = build_block_tables(batch["doc"], batch["pos"], batch["doc"],
                              batch["pos"])

    def flash(q, k, v):
        return kops.doc_flash_attention(q, k, v, doc, pos, doc, pos, tabs,
                                        grid="flat")

    def plain(q, k, v):
        return kops.doc_attention_plain(q, k, v, doc, pos, doc, pos,
                                        q_chunk=512)

    got, ms = {}, {}
    for name, fn in (("flash", flash), ("plain", plain)):
        ctx = ExecContext(doc=doc, pos=pos, attn=fn)
        reset_counts()
        y = attn_apply(p, cfg, ctx, x)
        grads = torch.autograd.grad(y, [x, *p.values()], w)
        got[name] = [y.detach(), *grads]
        if name == "flash":
            launches = read_counts()
        ms[name] = time_fb(torch, lambda: (attn_apply(p, cfg, ctx, x),
                                           [x, *p.values()], w))
        del y, grads
    names = ["y", "dx", *(f"d{n}" for n in p)]
    err = {n: _rel(a, b) for n, a, b in zip(names, got["flash"],
                                              got["plain"])}
    want = {n: 1 if n in DOC_KERNELS else 0 for n in launches}
    out = {"heads": f"{hq}/{hkv}", "tokens": T, "rel_err": err,
           "tol": DOC_TOL["bfloat16"], "launches": launches,
           "expected_launches": want,
           "flash_fwd_ms": ms["flash"][0], "flash_fwd_bwd_ms": ms["flash"][1],
           "plain_fwd_ms": ms["plain"][0], "plain_fwd_bwd_ms": ms["plain"][1]}
    emit("jamba_attn_layer", card=card_line(), **out)
    if launches != want:
        raise AssertionError(f"jamba attention launches {launches}, want "
                             f"{want}")
    if max(err.values()) > DOC_TOL["bfloat16"]:
        raise AssertionError(f"jamba attention flash vs plain: {err}")
    return out


def scan_island_inputs(torch, reset):
    """dt, A, Bm, Cm, xf and the output cotangent w of the selective-scan
    island check at jamba's widths (d_inner 8192, d_state 16), f32, from
    a seed: the same numbers in every process on the card."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    T, di, S = reset.shape[1], 8192, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    dt = torch.nn.functional.softplus(randn(1, T, di) * 0.5 - 2.0)
    A = -torch.arange(1, S + 1, dtype=torch.float32,
                      device="cuda")[None].expand(di, S).contiguous()
    return [dt, A, randn(1, T, S), randn(1, T, S), randn(1, T, di), reset,
            randn(1, T, di)]


SCAN_WRT = (0, 1, 2, 3, 4)          # dt, A, Bm, Cm, xf
SCAN_NAMES = ("y", "ddt", "dA", "dBm", "dCm", "dxf")


def scan_run(torch, args, scan):
    """y and the gradients of sum(y * w) wrt dt, A, Bm, Cm, xf."""
    ins = [a.clone().requires_grad_(i in SCAN_WRT)
           for i, a in enumerate(args[:6])]
    y = scan(*ins)
    grads = torch.autograd.grad(y, [ins[i] for i in SCAN_WRT], args[6])
    return [y.detach(), *grads]


def scan_island_rows(torch, comm, dev, rank: int, world: int,
                     ref_path: str) -> dict:
    """One rank of the selective-scan island: its token slice through
    ``_selective_scan_island``, dA summed over the ranks, each held
    against the one-rank run's slice (read from ``ref_path``, mapped)."""
    from repro_torch.core.comm import all_reduce_
    from repro_torch.core.cp_attention import _selective_scan_island

    ref = torch.load(ref_path, mmap=True)
    args = scan_island_inputs(torch, ref["reset"].to(dev))
    t_loc = args[0].shape[1] // world
    sl = slice(rank * t_loc, (rank + 1) * t_loc)
    mine = [a if i == 1 else a[:, sl].contiguous()
            for i, a in enumerate(args)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = scan_run(torch, mine, lambda *a: _selective_scan_island(
        *a, comm=comm))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    all_reduce_([out[2]], comm)
    errs = {}
    for name, got in zip(SCAN_NAMES, out):
        want = ref[name] if name == "dA" else ref[name][:, sl]
        want = want.to(dev)
        errs[name] = ((got - want).abs().max()
                      / ref[f"{name}_max"]).item()
    return {"rank": rank, "rel_err": errs, "seconds": secs}


def scan_island_reference(torch, path: str) -> float:
    """The one-rank chunked scan of the selective-scan island check (one
    SCAN_SEQ-token wlb_llm sequence at jamba's widths, f32), saved to
    ``path`` for the ranks; returns its seconds."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.models.context import local_selective_scan

    batch = make_batch(PipelineConfig(
        dataset="wlb_llm", context_len=SCAN_SEQ, batch_per_host=1,
        cp_size=1, strategy="contiguous", vocab_size=512, seed=0,
        align=1), 0)
    reset = torch.as_tensor(batch["pos"] > 0, dtype=torch.float32,
                            device="cuda")
    args = scan_island_inputs(torch, reset)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = scan_run(torch, args, local_selective_scan)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del args
    saved = {"reset": reset.cpu()}
    for name, t in zip(SCAN_NAMES, ref):
        saved[name] = t.cpu()
        saved[f"{name}_max"] = t.abs().max().item()
    del ref
    torch.save(saved, path)
    gc.collect()
    torch.cuda.empty_cache()
    return one_s


def scan_island_report(torch, ranks, one_s: float, wall: float) -> dict:
    """``_selective_scan_island`` at N = SCAN_WORLD: every rank's y and
    gradients (dA summed over the ranks) against the one-rank chunked
    scan, within REC_CP_TOL of each array's largest entry."""
    worst = max(v for x in ranks for v in x["rel_err"].values())
    out = {"world": SCAN_WORLD, "backend": cp_backend(torch, SCAN_WORLD),
           "tokens": SCAN_SEQ, "d_inner": 8192, "d_state": 16,
           "dtype": "float32", "one_rank_s": one_s, "wall_s": wall,
           "tol": REC_CP_TOL, "worst_rel_err": worst, "ranks": ranks}
    emit("jamba_scan_island", card=card_line(), **out)
    if not worst <= REC_CP_TOL:
        raise AssertionError(f"selective-scan island vs one rank: {worst}")
    return out


def jamba_layers_phase(torch) -> dict:
    """jamba at full width sublayer by sublayer on one 8192-token wlb_llm
    sequence: a Mamba sublayer and an attention sublayer through the doc
    kernels.  The selective-scan island at N = 4 runs in
    :func:`rec_cp_phase`."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch

    batch = make_batch(PipelineConfig(
        dataset="wlb_llm", context_len=SEQ, batch_per_host=1, cp_size=1,
        strategy="contiguous", vocab_size=512, seed=0, align=128), 0)
    out = {"mamba": jamba_mamba_layer(torch, batch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["attn"] = jamba_attn_layer(torch, batch)
    return out


def rec_cp_rank(rank, world, backend, store, out_dir, grad_dir, cases,
                scan_ref):
    """One rank of the recurrent checks on N ranks: the selective-scan
    island against the one-rank scan saved at ``scan_ref``
    (:func:`scan_island_rows`), then the models' step 0 on a 1xN mesh
    (ZeRO-3, contiguous, the scan islands and the convolution halo),
    f32, for each ``(what, arch, smoke, layers, seq, cfg_kw)`` of
    ``cases`` in turn: its loss, launches and peak; rank 0 saves each
    case's whole gradients to ``grad_dir/<what>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank

    comm, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        scan = scan_island_rows(torch, comm, dev, rank, world, scan_ref)
        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_local_mesh(1, world, device_type="cuda")
        out = []
        for what, arch, smoke, layers, seq, cfg_kw in cases:
            reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, grads = step0_grads("float32", mesh, dev, backend,
                                      layers=layers, seq=seq, arch=arch,
                                      cfg_kw=cfg_kw, smoke=smoke)
            secs = time.perf_counter() - t0
            if rank == 0:
                torch.save(grads, Path(grad_dir) / f"{what}.pt")
            del grads
            gc.collect()
            torch.cuda.empty_cache()
            out.append({"what": what, "rank": rank, "loss": loss,
                        "seconds": secs, "launches": read_counts(),
                        "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump({"steps": out, "scan": scan}, f)
    finally:
        dist.destroy_process_group()


def rec_cp_phase(torch) -> dict:
    """The recurrent families' N-rank checks in one spawn of N ranks (a
    spawn costs 10-25 s before any work): the selective-scan island at
    jamba's widths (:func:`scan_island_report`), then step 0 of the
    smoke jamba (drop-free) and of full-width xlstm_350m on a 1xN mesh
    against one rank, f32: for each, the loss within REC_CP_TOL and every
    gradient leaf within its bound (REC_CP_TOL; XLSTM_CP_LEAF_TOL for
    xLSTM), every rank's launches exactly the case's (jamba: local KV +
    N-1 hops a layer; xLSTM: none).  Emits the ``jamba_scan_island``,
    ``jamba_smoke_cp`` and ``xlstm_cp`` lines."""
    import tempfile
    from repro_torch.configs import get_config, reduce_for_smoke

    world = REC_SMOKE_WORLD
    jcfg = reduce_for_smoke(get_config(JAMBA))
    L = attn_layers(jcfg)
    jamba_want = {n: 0 for n in REPLACES} | {
        "flash_fwd": 2 * L * world, "flash_bwd_dq": L * world,
        "flash_bwd_dkv": L * world}
    # (what, arch, smoke, layers, seq, cfg_kw), want launches, leaf bound
    cases = [(("jamba_smoke_cp", JAMBA, True, 0, REC_SMOKE_SEQ,
               {"capacity_factor": float(jcfg.num_experts) / jcfg.top_k}),
              jamba_want, REC_CP_TOL),
             (("xlstm_cp", XLSTM, False, 0, SEQ, None),
              {n: 0 for n in REPLACES}, XLSTM_CP_LEAF_TOL)]
    if SCAN_WORLD != world:
        raise AssertionError("the scan island shares the 1xN checks' spawn")
    one = {}
    for (what, arch, smoke, layers, seq, cfg_kw), _, _ in cases:
        t0 = time.perf_counter()
        loss1, g1 = step0_grads("float32", layers=layers, seq=seq,
                                arch=arch, cfg_kw=cfg_kw, smoke=smoke)
        one[what] = (loss1, g1, time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    backend = cp_backend(torch, world)
    out = {}
    with tempfile.TemporaryDirectory() as grad_dir:
        scan_ref = f"{grad_dir}/scan_ref.pt"
        scan_one_s = scan_island_reference(torch, scan_ref)
        t0 = time.perf_counter()
        ranks = run_ranks(torch, rec_cp_rank, world, grad_dir,
                          [c[0] for c in cases], scan_ref)
        wall = time.perf_counter() - t0
        out["scan_island"] = scan_island_report(
            torch, [r["scan"] for r in ranks], scan_one_s, wall)
        for (what, arch, smoke, _, seq, cfg_kw), want_launches, leaf_tol \
                in cases:
            loss1, g1, one_s = one.pop(what)
            leaf = compare_grads(torch.load(Path(grad_dir) / f"{what}.pt"),
                                 g1)
            del g1
            rows = [x for r in ranks for x in r["steps"]
                    if x["what"] == what]
            d_loss = max(abs(x["loss"] - loss1) / abs(loss1) for x in rows)
            res = {"arch": arch, "smoke": smoke, "world": world,
                   "backend": backend, "strategy": "contiguous",
                   "dtype": "float32", "seq_len": seq,
                   "cfg_kw": cfg_kw or {}, "one_rank_loss": loss1,
                   "one_rank_s": one_s, "wall_s": wall,
                   "spawn": "one spawn for the scan island, " + ", ".join(
                       c[0][0] for c in cases),
                   "loss_rel_diff": d_loss,
                   "grad_rel_err": leaf["grad_rel_err"],
                   "worst_leaves": leaf["leaves"][:6],
                   "loss_tol": REC_CP_TOL, "leaf_tol": leaf_tol,
                   "expected_launches": want_launches,
                   "ranks": [{k: x[k] for k in (
                       "rank", "loss", "seconds", "launches",
                       "peak_bytes")} for x in rows]}
            emit(what, card=card_line(), **res)
            if len(rows) != world or not (
                    d_loss <= REC_CP_TOL
                    and leaf["leaves"][0]["rel_err"] <= leaf_tol):
                raise AssertionError(f"{what}: loss {d_loss:.3g}, worst "
                                     f"leaf {leaf['leaves'][0]}")
            if any(x["launches"] != want_launches for x in rows):
                raise AssertionError(f"{what}: launches "
                                     f"{[x['launches'] for x in rows]}, "
                                     f"want {want_launches} per rank")
            out[what] = res
    return out


def jamba_smoke_phase(torch) -> dict:
    """jamba at smoke width (one period of 8 layers, d 64), f32: trained
    REC_SMOKE_STEPS steps through the kernels on the card and through
    their twins on the CPU from the same parameters (same losses and
    parameters within SMOKE_TRAIN_TOL; the card's launches (2, 1, 1) a
    step for its one attention layer).  Its 1x4 step 0 runs in
    :func:`rec_cp_phase`."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params
    from repro_torch.optim._slices import leaves

    cfg = reduce_for_smoke(get_config(JAMBA))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        res = train(train_args("--arch", JAMBA, "--smoke", "--steps",
                               str(REC_SMOKE_STEPS), "--seq-len", "512",
                               "--batch", "2", "--device", dev,
                               "--log-every", "100"),
                    params=_to(params_cpu, dev))
        runs[dev] = (res["losses"], [p.detach().float().cpu()
                                     for p in leaves(res["params"])],
                     read_counts(), res["step_s"])
    L = attn_layers(cfg)
    want = {n: 0 for n in REPLACES} | {
        "flash_fwd": REC_SMOKE_STEPS * L * 2,
        "flash_bwd_dq": REC_SMOKE_STEPS * L,
        "flash_bwd_dkv": REC_SMOKE_STEPS * L}
    d_loss = max(abs(a - b) / abs(b)
                 for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    d_par = max((a - b).abs().max().item()
                for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
    out = {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
           "step_s_cuda": runs["cuda"][3], "loss_rel_diff": d_loss,
           "param_max_abs_diff": d_par, "tol": SMOKE_TRAIN_TOL,
           "launches": runs["cuda"][2], "expected_launches": want}
    emit("jamba_smoke_train_cuda_vs_cpu", card=card_line(), **out)
    if not (d_loss <= SMOKE_TRAIN_TOL and d_par <= SMOKE_TRAIN_TOL):
        raise AssertionError("jamba smoke training: cuda and cpu disagree")
    if runs["cuda"][2] != want:
        raise AssertionError(f"jamba smoke launches {runs['cuda'][2]}, want "
                             f"{want}")
    return out


def xlstm_train_phase(torch) -> dict:
    """xlstm_350m at full width and full depth (24 layers, 0.475 B
    parameters), bf16 with an fp32 master, one 8192-token wlb_llm
    sequence a step, XLSTM_STEPS steps (the run asks for flashcp and
    trains on contiguous): finite losses and no launch of any of the
    five kernels (the stack has no attention).  Its 1x4 step 0 (ZeRO-3,
    the chunk-state scans through ``_ssm_island``, the mLSTM's chunk
    states across the rank boundary through the halo) runs in
    :func:`rec_cp_phase`."""
    import math

    cfg = rec_cfg(XLSTM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train(train_args("--arch", XLSTM, "--seq-len", str(SEQ),
                           "--batch", "1", "--steps", str(XLSTM_STEPS),
                           "--device", "cuda", "--log-every", "100"))
    wall = time.perf_counter() - t0
    launches = read_counts()
    mean_s = statistics.mean(res["step_s"][1:])
    out = {"arch": XLSTM, "layers": cfg.num_layers,
           "params": cfg.param_count(), "seq_len": SEQ,
           "steps": XLSTM_STEPS, "strategy": res["run"].cp_strategy,
           "wall_s": wall, "losses": res["losses"],
           "grad_norms": res["grad_norms"], "step_s": res["step_s"],
           "step_s_after_first": mean_s, "tokens_per_s": SEQ / mean_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    emit("xlstm_train", card=card_line(), **out)
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError("xLSTM training produced non-finite losses")
    if any(launches.values()):
        raise AssertionError(f"xLSTM training launched kernels: {launches}")
    if out["strategy"] != "contiguous":
        raise AssertionError(f"xLSTM trained on {out['strategy']}")
    return out


def xlstm_serve_phase(torch) -> dict:
    """xlstm_350m at full depth serving the jamba_serve load (dense
    layout, replay prefill): every request ok, no kernel launched; then
    a small f32 xLSTM served on the card and on the CPU on 3 slots (so
    slots are reused): the same greedy tokens."""
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models import init_params

    cfg = rec_cfg(XLSTM)
    params = init_params(cfg, seed=0, device="cuda")
    prompts = rec_requests(cfg)
    eng, _, launches, wall, peak = serve_run(
        torch, cfg, params, "dense", prompts, REC_GEN, num_slots=REC_SLOTS,
        prefill_chunk=64)
    out = {"arch": XLSTM, "layers": cfg.num_layers,
           "requests": len(prompts), "slots": REC_SLOTS, "gen": REC_GEN,
           "wall_s": wall, **eng.throughput(),
           "stats": {k: v for k, v in eng.stats.items()
                     if not isinstance(v, dict)},
           "launches": launches, "peak_bytes": peak,
           "state_bytes": eng.kv_cache_bytes(),
           "latency": eng.latency_percentiles()}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    small = reduce_for_smoke(cfg)
    params_cpu = init_params(small, seed=3, device="cpu")
    small_prompts = requests(small, n=6, lo=20, hi=60, prefix=0, seed=4)
    toks = {}
    for dev, p in (("cuda", _to(params_cpu, "cuda")), ("cpu", params_cpu)):
        _, res, _, _, _ = serve_run(torch, small, p, "dense", small_prompts,
                                    12, device=dev, num_slots=3,
                                    prefill_chunk=16)
        toks[dev] = {r: e["tokens"].tolist() for r, e in res.items()}
    out["smoke_cuda_vs_cpu_identical"] = toks["cuda"] == toks["cpu"]
    emit("xlstm_serve", card=card_line(), **out)
    if any(launches.values()):
        raise AssertionError(f"xLSTM serving launched kernels: {launches}")
    if not out["smoke_cuda_vs_cpu_identical"]:
        raise AssertionError("xLSTM smoke serving: cuda and cpu tokens "
                             "differ")
    return out


# ----------------------------------------------------------------------- #
# the training path
# ----------------------------------------------------------------------- #
def train_args(*extra):
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args(list(extra))


def train(args, params=None, mesh=None, device=None):
    from repro_torch.launch.train import train as run_train
    return run_train(args, params, mesh=mesh, device=device)


# device-time categories of a profile, by kernel name
CATEGORIES = (("doc_attention", ("fwd_kernel", "fwd_mma_kernel", "dq_kernel",
                                  "dq_mma_kernel", "dkv_kernel",
                                  "dkv_mma_kernel", "dkv_sum_kernel")),
              ("flash_decode", ("decode_split_kernel",
                                "decode_combine_kernel")),
              ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")))


# the scalar f32 doc kernels: a bf16 step must launch none of them
SCALAR_DOC = re.compile(r"(?<![a-z_])(fwd|dq|dkv)_kernel(?![a-z_])")


def device_busy(prof, steps: int = 1):
    """(device busy ms, ms by category, top kernels) per step from a
    profiler run: only device-side (kernel and copy) events count; a CPU
    operator's device time is that of the kernels it launched, counted
    there already."""
    from torch.autograd import DeviceType
    rows, total = [], 0.0
    by_cat = {c: 0.0 for c, _ in CATEGORIES} | {"other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / steps / 1e3
        if ms > 0:
            rows.append({"name": ev.key[:80], "ms": ms,
                         "calls": ev.count // steps})
            total += ms
            cat = next((c for c, keys in CATEGORIES
                        if any(k in ev.key for k in keys)), "other")
            by_cat[cat] += ms
    rows.sort(key=lambda r: -r["ms"])
    return total, by_cat, rows[:12]


def profile_train_step(torch, res) -> dict:
    """Device time by kernel over one more full-width training step, and
    the device's idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device

    batch = batch_to_device(make_batch(res["pipeline"], STEPS), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = res["step_fn"](res["params"], res["opt_state"], batch, STEPS)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, by_cat, top = device_busy(prof)
    from torch.autograd import DeviceType
    scalar = sorted({ev.key[:80] for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA
                     and SCALAR_DOC.search(ev.key)})
    out = {"wall_ms": wall * 1e3, "device_busy_ms": total,
           "busy_ms_by_category": by_cat,
           "idle_share": None if not total else max(0.0, 1 - total
                                                    / (wall * 1e3)),
           "top": top, "scalar_doc_kernels": scalar}
    emit("profile_train_step", **out)
    if scalar:
        raise AssertionError(f"the bf16 step ran scalar kernels: {scalar}")
    return out


def table_gate(pipe, steps: int) -> None:
    """The verifier's TAB and WQ rules on every step's visit tables of a
    training run (rank 0): the rect fwd/dQ tables against the dense
    token-level visibility oracle (``check_block_tables``), and the flat
    work queues the kernels ran, forward (fwd/dQ) and reverse (dK/dV),
    against the rect tables they flatten (``check_work_queue``).  The
    batches are rebuilt from the run's pipeline with both grids; their
    flat queues must equal the run's own.  Raises on an error finding."""
    import dataclasses
    import numpy as np
    from repro_torch.analysis import errors, format_findings
    from repro_torch.analysis.plan_check import (check_block_tables,
                                                 check_work_queue)
    from repro_torch.data.pipeline import make_batch

    both = dataclasses.replace(pipe, table_grid="both")
    found, t0 = [], time.perf_counter()
    for step in range(steps):
        b, ran = make_batch(both, step), make_batch(pipe, step)
        if any(not np.array_equal(b[k], ran[k]) for k in ran
               if k.startswith("tab_")):
            raise AssertionError(f"step {step}: the tables differ from the "
                                 "run's")
        t = {k[len("tab_loc_"):]: v[:, 0] for k, v in b.items()
             if k.startswith("tab_loc_")}
        ctx = f"train step {step}"
        found += check_block_tables(
            b["doc"], b["pos"], b["doc"], b["pos"], t["kv_idx"],
            t["kv_nvis"], block_q=T_BLOCK, block_k=T_BLOCK,
            context=f"{ctx} fwd")
        found += check_work_queue(t["kv_idx"], t["kv_nvis"], t["fq_row"],
                                  t["fq_col"], t["fq_flags"],
                                  context=f"{ctx} fwd queue")
        found += check_work_queue(t["q_idx"], t["q_nvis"], t["rq_row"],
                                  t["rq_col"], t["rq_flags"],
                                  context=f"{ctx} reverse queue")
    emit("train_table_check", steps=steps, findings=[f.render()
                                                      for f in found],
         seconds=time.perf_counter() - t0)
    if errors(found):
        raise AssertionError(format_findings(found))


def one_doc_fwd(torch, gen, length: int):
    """bf16 ``flash_fwd`` at the training heads over one document of
    ``length`` tokens (flat grid): a call and its visited block pairs."""
    import numpy as np
    from repro_torch.kernels import doc_attention as da

    doc = np.zeros((1, length), np.int32)
    pos = np.arange(length, dtype=np.int32)[None]
    t = da.build_block_tables(doc, pos, doc, pos, block_q=T_BLOCK,
                              block_k=T_BLOCK)
    tabs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                 for a in (t.fq_row, t.fq_col, t.fq_flags))
    meta = [torch.from_numpy(a).to("cuda") for a in (doc, pos, doc, pos)]
    q, k, v = (torch.randn((1, h, length, T_D), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (T_HQ, T_HKV, T_HKV))
    kw = dict(scale=T_D ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK,
              grid="flat")
    return (lambda: da.flash_fwd(q, k, v, *meta, tabs, **kw)), \
        int(t.kv_nvis.sum())


def fit_l_half(lengths, shares) -> float:
    """The L_HALF of eff(L) = L / (L + L_HALF) that fits ``shares`` best
    (least squares over a log grid, then refined)."""
    import numpy as np
    L, y = np.asarray(lengths, float), np.asarray(shares, float)
    grid = np.logspace(0, 8, 4001)
    err = ((y[None] - L[None] / (L[None] + grid[:, None])) ** 2).sum(1)
    i = int(np.argmin(err))
    fine = np.linspace(grid[max(i - 1, 0)], grid[min(i + 1, len(grid) - 1)],
                       2001)
    err = ((y[None] - L[None] / (L[None] + fine[:, None])) ** 2).sum(1)
    return float(fine[int(np.argmin(err))])


def calibrate_peak_flops(torch, timer, gen) -> dict:
    """bf16 ``torch.matmul`` at the main path's MLP shape: its FLOP/s."""
    M, K, N = CAL_MATMUL
    a = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    b = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    ms = timer(lambda: torch.matmul(a, b), reps=CAL_REPS)
    return {"value": 2 * M * K * N / (ms * 1e-3), "ms": ms,
            "what": f"bf16 matmul {M}x{K}x{N}"}


def calibrate_hbm_bw(torch, timer) -> dict:
    """A 1 GiB device-to-device copy: bytes read plus written per s."""
    src = torch.empty(CAL_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = timer(lambda: dst.copy_(src), reps=CAL_REPS)
    return {"value": 2 * CAL_COPY_BYTES / (ms * 1e-3), "ms": ms,
            "what": "1 GiB copy, read + write"}


def calibrate_kernel_overhead(torch, timer, gen) -> dict:
    """One ``flash_fwd`` call over a single visited 128 x 128 tile."""
    call, visits = one_doc_fwd(torch, gen, CAL_ONE_TILE)
    ms = timer(call, reps=CAL_REPS)
    return {"value": ms * 1e-3, "ms": ms, "visits": visits,
            "what": "flash_fwd, one visited tile"}


def calibrate_copy_overhead(torch, timer, gen) -> dict:
    """One shard copy of the CP island's buffer: ``_take_tokens`` of a
    128-token shard of K at the training heads into the Eq.-5 buffer, a
    copy whose bytes take nanoseconds, so its time is the fixed cost."""
    from repro_torch.core.cp_attention import _take_tokens

    k = torch.randn((1, T_HKV, SEQ, T_D), generator=gen,
                    device="cuda").bfloat16()
    idx = torch.arange(CAL_ONE_TILE, dtype=torch.int32,
                       device="cuda")[None]
    ms = timer(lambda: _take_tokens(k, idx), reps=CAL_REPS)
    return {"value": ms * 1e-3, "ms": ms,
            "what": f"_take_tokens of {CAL_ONE_TILE} tokens"}


def calibrate_grid_step(torch, timer, gen) -> dict:
    """bf16 ``flash_fwd`` on the rect grid minus the flat grid over the
    main path's step-0 tables, over the two grids' step counts'
    difference (counted as ``autotune.measure._rank_counters`` counts
    them); with the rect grid's dQ and dK/dV times beside the flat ones,
    for PERF.md."""
    from repro_torch.kernels import doc_attention as da

    kw = dict(scale=T_D ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK)
    q, k, v, do = doc_inputs(torch, gen, torch.bfloat16)
    ms, steps = {}, {}
    for grid in ("flat", "rect"):
        batch = doc_batch(grid=grid)
        meta = [batch[n] for n in ("doc", "pos", "doc", "pos")]
        fwd_t, rev_t = doc_tables(batch, grid)
        steps[grid] = int(fwd_t[0].shape[-2] * fwd_t[0].shape[-1]) \
            if grid == "rect" else int(fwd_t[0].shape[-1])
        o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, grid=grid, **kw)
        delta = (do.float() * o.float()).sum(-1)
        ms[grid] = {
            "flash_fwd": timer(lambda: da.flash_fwd(
                q, k, v, *meta, fwd_t, grid=grid, **kw), reps=CAL_REPS),
            "flash_bwd_dq": timer(lambda: da.flash_bwd_dq(
                q, k, v, do, lse, delta, *meta, fwd_t, grid=grid, **kw),
                reps=CAL_REPS),
            "flash_bwd_dkv": timer(lambda: da.flash_bwd_dkv(
                q, k, v, do, lse, delta, *meta, rev_t, grid=grid, **kw),
                reps=CAL_REPS),
            "visits": visits_of(batch)}
    d_ms = ms["rect"]["flash_fwd"] - ms["flat"]["flash_fwd"]
    d_steps = steps["rect"] - steps["flat"]
    return {"value": d_ms * 1e-3 / d_steps, "ms": ms, "steps": steps,
            "what": "flash_fwd rect - flat over their step difference"}


def calibrate_l_half(torch, timer, gen, peak_flops: float) -> dict:
    """``flash_fwd`` on one document of each of CAL_DOC_LENS tokens: the
    achieved share of the cost model's bound (its operations at the
    measured ``peak_flops``), and the L_HALF of eff(L) = L / (L + L_HALF)
    that fits those shares."""
    rows = []
    for length in CAL_DOC_LENS:
        call, visits = one_doc_fwd(torch, gen, length)
        ms = timer(call, reps=CAL_REPS)
        flops = visits * T_HQ * MATMULS["flash_fwd"] * 2 * T_BLOCK \
            * T_BLOCK * T_D
        rows.append({"tokens": length, "visits": visits, "ms": ms,
                     "share": flops / peak_flops / (ms * 1e-3)})
    return {"value": fit_l_half([r["tokens"] for r in rows],
                                [r["share"] for r in rows]),
            "docs": rows, "what": "fit of eff(L) to flash_fwd's share"}


def cost_model_phase(torch, timer) -> dict:
    """Each constant of the cost model (``autotune.cost_model.HW`` and
    ``L_HALF``) measured on the card, printed in one
    ``cost_model_calibration`` line beside the package's value and their
    ratio (package / measured); ``ici_bw`` (NVLink through NCCL) needs
    more than one card (``scripts/nccl_allgather_bw.py``).  Fails if the
    package's ``peak_flops`` or ``hbm_bw`` is off by more than
    CAL_RATIO.  Also emits the bf16 rect grid's kernel times."""
    from repro_torch.autotune import cost_model as cm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    meas = {"peak_flops": calibrate_peak_flops(torch, timer, gen),
            "hbm_bw": calibrate_hbm_bw(torch, timer),
            "kernel_overhead_s": calibrate_kernel_overhead(torch, timer,
                                                           gen),
            "copy_overhead_s": calibrate_copy_overhead(torch, timer, gen),
            "grid_step_overhead_s": calibrate_grid_step(torch, timer, gen)}
    meas["L_HALF"] = calibrate_l_half(torch, timer, gen,
                                      meas["peak_flops"]["value"])
    package = {**cm.HW, "L_HALF": cm.L_HALF}
    rows = {n: {"measured": m["value"], "package": package[n],
                "ratio": package[n] / m["value"], **{
                    k: v for k, v in m.items() if k != "value"}}
            for n, m in meas.items()}
    rows["ici_bw"] = {"measured": None, "package": cm.HW["ici_bw"],
                      "note": "NVLink through NCCL: one card cannot "
                              "measure it; scripts/nccl_allgather_bw.py "
                              "on four cards"}
    emit("cost_model_calibration", card=card_line(), constants=rows,
         ratio_bound=CAL_RATIO)
    grid = meas["grid_step_overhead_s"]["ms"]
    emit("kernel_time_rect", dtype="bfloat16", card=card_line(),
         visits=grid["rect"]["visits"], steps=
         meas["grid_step_overhead_s"]["steps"],
         ms={g: {n: grid[g][n] for n in DOC_KERNELS} for g in grid})
    for n in ("peak_flops", "hbm_bw"):
        if not 1 / CAL_RATIO <= rows[n]["ratio"] <= CAL_RATIO:
            raise AssertionError(f"cost model {n} = {package[n]:.4g}, the "
                                 f"card measures {rows[n]['measured']:.4g}")
    return rows


def autotune_args(cache: str, *extra) -> list:
    return ["--arch", ARCH, "--seq-len", str(SEQ), "--batch", "1",
            "--steps", str(AUTOTUNE_STEPS), "--autotune",
            "--autotune-cache", cache, "--device", "cuda", "--log-every",
            "100", *extra]


def autotune_phase(torch, trained: dict) -> dict:
    """``train.py --autotune`` on the card: (a) the main path's model at
    full width and depth tuned (the cost model's pick of strategy,
    overlap, grid, dispatch and K/V wire) and trained AUTOTUNE_STEPS
    steps with the pick through the three doc kernels: finite losses,
    exactly steps x layers x (2, 1, 1) launches, step 0's loss beside
    ``train_phase``'s; (b) the same command with ``--autotune-dry``: a
    cache hit with the same pick; (c) ``--autotune-dry`` at the meshes of
    ``cp_train`` and ``dp_train``: each pick, no rank spawned; (d) the
    cost model's step seconds for (a)'s pick (predicted, its measured
    trial, and the prediction times the layers: the model prices one
    layer) beside the card's mean step: printed, not gated."""
    import math
    import multiprocessing
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    L = get_config(ARCH).num_layers
    want = {"flash_fwd": AUTOTUNE_STEPS * L * 2,
            "flash_bwd_dq": AUTOTUNE_STEPS * L,
            "flash_bwd_dkv": AUTOTUNE_STEPS * L}
    with tempfile.TemporaryDirectory() as cache:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = train_main(autotune_args(cache))
        wall = time.perf_counter() - t0
        launches = read_counts()
        tune = res["autotune"]
        mean_s = statistics.mean(res["step_s"][1:])
        out = {"arch": ARCH, "layers": L, "seq_len": SEQ,
               "steps": AUTOTUNE_STEPS, "wall_s": wall,
               "pick": tune["best"], "n_candidates": tune["n_candidates"],
               "top_k": tune["top_k"], "frontier_rho": tune["frontier_rho"],
               "cached": tune["cached"], "losses": res["losses"],
               "train_phase_step0_loss": trained["losses"][0],
               "step_s": res["step_s"], "step_s_after_first": mean_s,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "expected_launches": want,
               "predicted_step_s": tune["predicted"]["step_s"],
               "model_trial_step_s": tune["measured"]["step_s"],
               # the cost model prices one layer (ModelDims has no depth)
               "predicted_step_s_times_layers":
                   tune["predicted"]["step_s"] * L,
               "predicted_terms": tune["predicted"]}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        emit("autotune_train", card=card_line(), **out)
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError("autotuned training: non-finite losses")
        if any(launches[n] != want[n] for n in want):
            raise AssertionError(f"autotuned training launched {launches}, "
                                 f"want {want}")
        dry = train_main(autotune_args(cache, "--autotune-dry"))
        emit("autotune_dry", mesh="1x1", cached=dry["autotune"]["cached"],
             pick=dry["autotune"]["best"])
        if not dry["autotune"]["cached"] or \
                dry["autotune"]["best"] != tune["best"]:
            raise AssertionError(f"second --autotune: {dry['autotune']}")
    out["meshes"] = {}
    for mesh, seq, batch in (("1x4", CP_SEQ, 1),
                             ("2x2", DP_SEQ, DP_BATCH)):
        t0 = time.perf_counter()
        dry = train_main(["--arch", ARCH, "--seq-len", str(seq),
                          "--batch", str(batch), "--mesh", mesh,
                          "--dist-backend", "gloo", "--autotune",
                          "--autotune-dry", "--device", "cuda"])
        spawned = multiprocessing.active_children()
        row = {"mesh": mesh, "seq_len": seq, "batch": batch,
               "pick": dry["autotune"]["best"],
               "n_candidates": dry["autotune"]["n_candidates"],
               "frontier_rho": dry["autotune"]["frontier_rho"],
               "predicted_step_s": dry["autotune"]["predicted"]["step_s"],
               "seconds": time.perf_counter() - t0,
               "trained_steps": len(dry["losses"]),
               "live_children": len(spawned)}
        emit("autotune_dry", **row)
        if spawned or dry["losses"]:
            raise AssertionError(f"--autotune-dry at {mesh} ran ranks")
        out["meshes"][mesh] = row
    return out


def train_phase(torch) -> dict:
    """The main path: ``train`` at full width for STEPS steps through the
    kernels, launch counts read around it."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch

    cfg = get_config(ARCH)
    args = train_args("--arch", ARCH, "--seq-len", str(SEQ), "--batch", "1",
                      "--steps", str(STEPS), "--device", "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train(args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = {"flash_fwd": STEPS * L * 2, "flash_bwd_dq": STEPS * L,
            "flash_bwd_dkv": STEPS * L}
    visits = [visits_of(make_batch(res["pipeline"], s))
              for s in range(STEPS)]
    tokens = SEQ                       # processed per step (batch 1)
    # model flops: 6 N per token for the matrices (the embedding table, a
    # lookup, not counted) plus the attention's two products per visited
    # block pair and head, times 3 for forward and backward
    # (rematerialization not counted)
    n_dense = cfg.param_count() - cfg.vocab_size * cfg.d_model
    flops = [6 * n_dense * tokens + 3 * 2 * v * T_HQ * 2 * T_BLOCK
             * T_BLOCK * T_D * L for v in visits]
    step_s = res["step_s"][1:]
    mean_s = statistics.mean(step_s)
    mean_flops = statistics.mean(flops[1:])
    out = {"arch": ARCH, "params": cfg.param_count(), "seq_len": SEQ,
           "batch": 1, "steps": STEPS, "wall_s": wall,
           "losses": res["losses"], "grad_norms": res["grad_norms"],
           "lrs": res["lrs"], "step_s": res["step_s"],
           "step_s_after_first": mean_s, "tokens_per_s": tokens / mean_s,
           "visits_per_step": visits, "model_flops_per_step": flops,
           "model_tflops_per_s": mean_flops / mean_s / 1e12,
           "bf16_peak_share": mean_flops / mean_s / PEAK_FLOPS["bfloat16"],
           "peak_bytes": peak, "launches": launches,
           "expected_launches": want}
    emit("train_full_width", **out)
    finite = all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    if not finite:
        raise AssertionError("training produced non-finite losses")
    if any(launches[n] != want[n] for n in want):
        raise AssertionError(f"training launches {launches}, want {want}")
    table_gate(res["pipeline"], STEPS)
    out["profile"] = profile_train_step(torch, res)
    return out, res


def step_parity_phase(torch, res) -> None:
    """One full-width step from the trained parameters and one batch,
    loss and gradients through the kernels vs the plain attention."""
    import dataclasses
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.optim import global_norm

    batch = batch_to_device(make_batch(res["pipeline"], STEPS + 1), "cuda")
    got = {}
    for impl in ("flash", "plain"):
        run = dataclasses.replace(res["run"], attention_impl=impl)
        fn = build_train_step(res["config"], run, q_chunk=512,
                              device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, _), grads = fn.loss_and_grads(res["params"], batch)
        norm = float(global_norm(grads))
        got[impl] = {"loss": float(loss), "grad_norm": norm,
                     "seconds": time.perf_counter() - t0}
        del grads
        torch.cuda.empty_cache()
    d_loss = abs(got["flash"]["loss"] - got["plain"]["loss"]) \
        / abs(got["plain"]["loss"])
    d_norm = abs(got["flash"]["grad_norm"] - got["plain"]["grad_norm"]) \
        / got["plain"]["grad_norm"]
    emit("train_step_flash_vs_plain", **got, loss_rel_diff=d_loss,
         grad_norm_rel_diff=d_norm, loss_tol=STEP_LOSS_TOL,
         grad_norm_tol=STEP_GNORM_TOL)
    if not (d_loss <= STEP_LOSS_TOL and d_norm <= STEP_GNORM_TOL):
        raise AssertionError("flash and plain training steps disagree")


def step_audit_phase(torch, res) -> dict:
    """One more main-path step at full width, through the three doc
    kernels, from the trained parameters and optimizer state on the next
    batch of the stream, under the step audit
    (``analysis.step_audit``): exactly one ``train_step`` call inside
    it.  Gated: layers x (2, 1, 1) launches, no f64 and no host-sync site
    outside the module's ``cuda`` list; the sites on a line of their
    own."""
    import math
    from repro_torch.analysis.step_audit import (EXPECTED_SITES,
                                                 audit_findings, audit_step)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step

    batch = batch_to_device(make_batch(res["pipeline"], STEPS), "cuda")
    fn = build_train_step(res["config"], res["run"], device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics, audit = audit_step(fn, res["params"], res["opt_state"], batch,
                                STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    L = res["config"].num_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    sites = sorted({s.render() for s in audit.sites})
    findings = audit_findings(audit.sites, "cuda")
    print(json.dumps({"phase": "step_audit_sites", "device": "cuda",
                      "sites": sites}), flush=True)
    emit("step_audit", ops=audit.ops, flagged=len(audit.sites),
         seconds=seconds, loss=float(metrics["loss"]), launches=launches,
         expected_launches=want,
         expected_cuda_sites=[f"{f}:{fn_} {k}" for f, fn_, k in
                              EXPECTED_SITES["cuda"]],
         findings=[f.render() for f in findings])
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("the audited step's loss is not finite")
    if any(launches[n] != want[n] for n in want):
        raise AssertionError(f"audited step launches {launches}, want {want}")
    if findings:
        raise AssertionError("step audit: " + "; ".join(
            f.render() for f in findings))
    return {"sites": sites}


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clone(tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda x: x.clone() if hasattr(x, "clone") else x, tree)


def measured_run(torch, fn, *args, **kw) -> dict:
    """``fn(*args, **kw)`` as ``res``, with its wall time, the doc
    kernels' launches and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    return {"res": res, "wall_s": time.perf_counter() - t0,
            "launches": {n: read_counts()[n] for n in DOC_KERNELS},
            "peak_bytes": torch.cuda.max_memory_allocated()}


def examples_plain_rank(rank, world, backend, store, out_dir, params_path):
    """Worker 0 of the rank pool (no process group): train_lm's training
    through the plain attention from the parameters at ``params_path``,
    without its checkpoints (no gate reads them), its log in
    ``out_dir``; losses, step times, launches, peak."""
    import contextlib
    import torch
    import repro_torch.configs as configs

    tl = load_example("train_lm_torch")
    args = tl.train_args(["--attention-impl", "plain"])
    args.checkpoint_dir, args.ckpt_every, args.resume = "", 0, False
    configs.ARCHS[tl.LM_100M.name] = tl.LM_100M
    params = torch.load(params_path, map_location="cuda")
    try:
        with open(Path(out_dir) / "train_lm_plain.log", "w") as log, \
                contextlib.redirect_stdout(log):
            run = measured_run(torch, train, args, params)
    finally:
        configs.ARCHS.pop(tl.LM_100M.name, None)
    res = run.pop("res")
    run.update(losses=res["losses"], step_s=res["step_s"])
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(run, f)


def examples_phase(torch) -> dict:
    """The four examples' ``main`` on the card: plan_explorer and
    quickstart's plans on the host; quickstart's tiny training through
    the doc kernels (the loss falls, layers x (2, 1, 1) launches a step);
    serve_decode on the paged layout (every request ok with its tokens,
    ``flash_decode_paged`` launched (decode steps + the warmup's) x
    layers times); train_lm: lm_124m for EX_STEPS steps through the f32
    doc kernels (launches, the loss falls by EX_DROP nats) and, on a
    worker of the rank pool at the same time (the two share the card),
    the same steps through the plain attention from the same parameters
    (EX_STEP0_TOL, EX_TAIL_TOL), then resumed by the example from its
    checkpoint against an in-process continuation (see EX_*)."""
    import dataclasses
    import math
    import tempfile
    import repro_torch.configs as configs
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import init_params

    out = {}
    tl = load_example("train_lm_torch")
    cfg = tl.LM_100M
    with tempfile.TemporaryDirectory() as tmp:
        # the plain run starts first, on a worker of the rank pool
        params0 = init_params(cfg, seed=0, device="cuda")
        torch.save(params0, f"{tmp}/params0.pt")
        plain_job = PendingRanks(torch, examples_plain_rank, 1,
                                 (f"{tmp}/params0.pt",))

        t0 = time.perf_counter()
        load_example("plan_explorer_torch").main([])
        out["plan_explorer_s"] = time.perf_counter() - t0

        qs = load_example("quickstart_torch")
        qs.CKPT_DIR = f"{tmp}/quickstart"
        L = reduce_for_smoke(get_config("starcoder2_3b")).num_layers
        reset_counts()
        t0 = time.perf_counter()
        res = qs.main([])
        q = {"wall_s": time.perf_counter() - t0, "losses": res["losses"],
             "launches": {n: read_counts()[n] for n in DOC_KERNELS},
             "expected_launches": {
                 n: qs.TINY_STEPS * L * k
                 for n, k in zip(DOC_KERNELS, (2, 1, 1))}}
        del res
        emit("examples_quickstart", **q)
        if not (all(map(math.isfinite, q["losses"]))
                and q["losses"][-1] < q["losses"][0]):
            raise AssertionError(f"quickstart: losses {q['losses']}")
        if q["launches"] != q["expected_launches"]:
            raise AssertionError(f"quickstart: launches {q['launches']}")
        out["quickstart"] = q

        sd = load_example("serve_decode_torch")
        reset_counts()
        t0 = time.perf_counter()
        res = sd.main([])
        launches = read_counts()
        gen = 16                         # the example's --gen
        s = {"wall_s": time.perf_counter() - t0,
             "kv_layout": res["kv_layout"],
             "statuses": sorted(r["status"] for r in res["results"].values()),
             "tokens": [len(t) for t in res["tokens"].values()],
             "launches": launches["flash_decode_paged"],
             # the engine's warmup is one all-inactive decode step
             "expected_launches": (res["stats"]["decode_steps"] + 1) * L,
             "decode_tok_s": res["throughput"]["decode_tok_s"]}
        del res
        emit("examples_serve_decode", **s)
        if s["kv_layout"] != "paged" or s["statuses"] != ["ok"] * 4 \
                or s["tokens"] != [gen] * 4:
            raise AssertionError(f"serve_decode: {s}")
        if s["launches"] != s["expected_launches"] or not s["launches"]:
            raise AssertionError(f"serve_decode: launches {s['launches']}")
        out["serve_decode"] = s

        try:
            tl.CKPT_DIR = f"{tmp}/lm_flash"
            flash = measured_run(torch, tl.main, ["--attention-impl", "flash"],
                                 params=params0)
            del params0
            # EX_CONT more steps in process, twice from the same state, on
            # the learning-rate schedule of the resumed run (a
            # EX_STEPS + EX_CONT step run)
            res = flash.pop("res")
            total = EX_STEPS + EX_CONT
            run = dataclasses.replace(res["run"], total_steps=total,
                                      warmup_steps=max(total // 10, 1))
            step_fn = build_train_step(res["config"], run, q_chunk=128,
                                       device="cuda")
            dev = torch.device("cuda")
            batches = [batch_to_device(make_batch(res["pipeline"], s), dev)
                       for s in range(EX_STEPS, total)]
            cont = []
            for _ in range(2):
                p, o = _clone(res["params"]), _clone(res["opt_state"])
                cont.append([float(step_fn(p, o, b, s)["loss"]) for s, b
                             in zip(range(EX_STEPS, total), batches)])
                del p, o
            lf, steps_s = res["losses"], res["step_s"]
            del step_fn, batches, res
            spread = max(abs(x - y) for x, y in zip(*cont))
            t0 = time.perf_counter()
            resumed = tl.main(["--steps", str(total)])["losses"]
            resume_s = time.perf_counter() - t0
            resume_gap = max(abs(x - y) for x, y in zip(resumed, cont[0])) \
                if len(resumed) == EX_CONT else math.inf
        finally:
            configs.ARCHS.pop(cfg.name, None)
        t0 = time.perf_counter()
        (plain,) = plain_job.wait()
        plain_wait_s = time.perf_counter() - t0
    lp = plain["losses"]
    tail_f = statistics.mean(lf[-EX_TAIL:])
    tail_p = statistics.mean(lp[-EX_TAIL:])
    step0_gap = abs(lf[0] - lp[0]) / abs(lp[0])
    tail_gap = abs(tail_f - tail_p) / abs(tail_p)
    want = {n: EX_STEPS * cfg.num_layers * k
            for n, k in zip(DOC_KERNELS, (2, 1, 1))}
    lm = {"arch": cfg.name, "params": cfg.param_count(),
          "steps": EX_STEPS, "wall_s": flash["wall_s"],
          "ms_per_step": 1e3 * statistics.mean(steps_s[1:]),
          "plain_wall_s": plain["wall_s"],
          "plain_ms_per_step": 1e3 * statistics.mean(plain["step_s"][1:]),
          "plain_wait_s": plain_wait_s,
          "loss_first": lf[0], "loss_last": lf[-1],
          "loss_tail_mean": tail_f, "plain_loss_first": lp[0],
          "plain_loss_tail_mean": tail_p,
          "step0_gap": step0_gap, "step0_tol": EX_STEP0_TOL,
          "tail_gap": tail_gap, "tail_tol": EX_TAIL_TOL,
          "peak_bytes": flash["peak_bytes"],
          "plain_peak_bytes": plain["peak_bytes"],
          "launches": flash["launches"], "expected_launches": want,
          "plain_launches": plain["launches"],
          "continued": cont[0], "resumed": resumed,
          "continuation_spread": spread, "resume_gap": resume_gap,
          "resume_s": resume_s}
    emit("examples_train_lm", **lm)
    if not all(map(math.isfinite, lf + lp)):
        raise AssertionError("train_lm: non-finite losses")
    if not tail_f <= lf[0] - EX_DROP:
        raise AssertionError(f"train_lm: the loss fell from {lf[0]} to a "
                             f"mean of {tail_f} over the last {EX_TAIL}")
    if lm["launches"] != want or any(lm["plain_launches"].values()):
        raise AssertionError(f"train_lm: launches {lm['launches']} (want "
                             f"{want}), plain {lm['plain_launches']}")
    if step0_gap > EX_STEP0_TOL or tail_gap > EX_TAIL_TOL:
        raise AssertionError(f"train_lm kernels vs plain: step 0 "
                             f"{step0_gap}, last {EX_TAIL} {tail_gap}")
    if not resume_gap <= EX_RESUME_SPREADS * spread:
        raise AssertionError(f"train_lm resumed {resumed} against the "
                             f"in-process {cont[0]} (spread {spread})")
    out["train_lm"] = lm
    return out


def smoke_train_phase(torch) -> None:
    """A small f32 model trained 3 steps through the kernels on the card
    and through their twins on the CPU, from the same seed and batches."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params
    from repro_torch.optim._slices import leaves

    params_cpu = init_params(reduce_for_smoke(get_config(ARCH)), seed=0,
                             device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        res = train(train_args("--smoke", "--steps", "3", "--seq-len", "512",
                               "--batch", "2", "--device", dev,
                               "--log-every", "100"),
                    params=_to(params_cpu, dev))
        out[dev] = (res["losses"], [p.detach().float().cpu()
                                    for p in leaves(res["params"])])
        if dev == "cuda" and not all(read_counts()[n] for n in DOC_KERNELS):
            raise AssertionError("smoke training launched no doc kernel")
    d_loss = max(abs(a - b) / abs(b)
                 for a, b in zip(out["cuda"][0], out["cpu"][0]))
    d_par = max((a - b).abs().max().item()
                for a, b in zip(out["cuda"][1], out["cpu"][1]))
    emit("smoke_train_cuda_vs_cpu", losses_cuda=out["cuda"][0],
         losses_cpu=out["cpu"][0], loss_rel_diff=d_loss,
         param_max_abs_diff=d_par, tol=SMOKE_TRAIN_TOL)
    if not (d_loss <= SMOKE_TRAIN_TOL and d_par <= SMOKE_TRAIN_TOL):
        raise AssertionError("cuda and cpu smoke training disagree")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------------------- #
# the audio and VLM frontends: musicgen_medium and internvl2_1b
# ----------------------------------------------------------------------- #
def frontend_inputs(cfg, perm, seed: int) -> dict:
    """The family's frontend keys for a batch in plan order ``perm`` (B,
    C): embeddings drawn from ``seed`` in natural token order and put
    through ``perm`` as the pipeline puts tokens (padding zeros); the
    first ``num_patch_tokens`` natural positions of a row are patches.
    No data source of the repo makes these inputs."""
    import numpy as np
    if cfg.frontend == "none":
        return {}
    rng = np.random.default_rng(seed)
    valid = perm >= 0
    emb = rng.standard_normal((*perm.shape, cfg.d_model)).astype(np.float32)
    plan = np.take_along_axis(emb, np.where(valid, perm, 0)[..., None],
                              axis=1)
    plan[~valid] = 0.0
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": plan}
    return {"patch_embeds": plan,
            "patch_mask": valid & (perm < cfg.num_patch_tokens)}


def decode_kernel_checks(torch, timer, gen, hq, hkv, d, tag) -> dict:
    """Both decode kernels at (hq, hkv, d) on the serving batch of B rows
    (lengths <= S_DENSE): f32 and bf16 against their plain versions and
    split twins; bf16 times beside the bound, the plain version and one
    SDPA call."""
    from repro_torch.core.merge import finalize_partial
    from repro_torch.kernels import flash_decode as fd

    err = {"flash_decode": 0.0, "flash_decode_paged": 0.0}
    for name in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, name), TOL[name]
        q, k, v, ln = dense_case(torch, dtype, gen, hq, hkv, d)
        out = fd.flash_decode(q, k, v, ln)
        o, m, l = fd.flash_decode(q, k, v, ln, partial=True)
        torch.cuda.synchronize()
        ref = fd.decode_reference(q, k, v, ln)
        e_norm = _err(out, ref)
        e_part = _err(finalize_partial((o, m, l), torch.float32), ref)
        dpps, _ = dense_split(torch, S_DENSE, hkv)
        tw = fd.decode_split_plain(q, k, v, ln, tile=fd.DENSE_TILE,
                                   pages_per_split=dpps, partial=True)
        e_dtwin = _err(finalize_partial((o, m, l), torch.float32),
                       finalize_partial(tw, torch.float32))
        qp, kp, vp, lp, tp = paged_case(torch, dtype, gen, hq, hkv, d)
        outp = fd.flash_decode_paged(qp, kp, vp, lp, tp, block_size=BLOCK)
        torch.cuda.synchronize()
        e_paged = _err(outp, fd.paged_decode_reference(
            qp, kp, vp, lp, tp, block_size=BLOCK))
        pps, _ = paged_split(torch, tp, hkv)
        e_ptwin = _err(outp, fd.paged_decode_split_plain(
            qp, kp, vp, lp, tp, block_size=BLOCK, pages_per_split=pps))
        emit("frontend_decode_parity", arch=tag, heads=f"{hq}/{hkv}", d=d,
             dtype=name, tol=tol, flash_decode_err=e_norm,
             flash_decode_partial_err=e_part,
             flash_decode_vs_split_twin_err=e_dtwin,
             flash_decode_paged_err=e_paged,
             flash_decode_paged_vs_split_twin_err=e_ptwin)
        if max(e_norm, e_part, e_dtwin, e_paged, e_ptwin) > tol:
            raise AssertionError(f"decode kernels at {hq}/{hkv} heads, D "
                                 f"{d}, {name}: parity failed")
        err["flash_decode"] = max(err["flash_decode"], e_norm, e_part,
                                  e_dtwin)
        err["flash_decode_paged"] = max(err["flash_decode_paged"], e_paged,
                                        e_ptwin)
    return {"err": err, "times": decode_times(
        torch, timer, gen, hq, hkv, d, normalized=False,
        phase="frontend_kernel_time", arch=tag, heads=f"{hq}/{hkv}",
        head_dim=d)}


def doc_kernel_checks(torch, timer, gen, hq, hkv, d, tag) -> dict:
    """The three doc kernels at (hq, hkv, d) on one SEQ-token wlb_llm
    sequence (blocks 128, flat tables): f32 and bf16 against their twins
    on the batch with 300 padding tokens; bf16 times on the unpadded one
    beside the bound, the twin and SDPA."""
    from repro_torch.kernels import doc_attention as da

    err = {n: 0.0 for n in DOC_KERNELS}
    kw = dict(scale=d ** -0.5, block_q=T_BLOCK, block_k=T_BLOCK,
              grid="flat")
    for name in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, name), DOC_TOL[name]
        batch = doc_batch(pad=300)
        meta = [batch[x] for x in ("doc", "pos", "doc", "pos")]
        fwd_t, rev_t = doc_tables(batch, "flat")
        q, k, v, do = doc_inputs(torch, gen, dtype, hq, hkv, d)
        o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
        po, plse = da.flash_fwd_plain(q, k, v, *meta, fwd_t, **kw)
        fin = ~torch.isinf(plse)
        e_o = _err(o, po)
        e_lse = (lse[fin] - plse[fin]).abs().max().item()
        delta = (do.float() * po.float()).sum(-1)
        dq = da.flash_bwd_dq(q, k, v, do, plse, delta, *meta, fwd_t, **kw)
        dk, dv = da.flash_bwd_dkv(q, k, v, do, plse, delta, *meta, rev_t,
                                  **kw)
        torch.cuda.synchronize()
        pdq = da.flash_bwd_dq_plain(q, k, v, do, plse, delta, *meta, fwd_t,
                                    **kw)
        pdk, pdv = da.flash_bwd_dkv_plain(q, k, v, do, plse, delta, *meta,
                                          rev_t, **kw)
        grads = {"dq": (dq, pdq), "dk": (dk, pdk), "dv": (dv, pdv)}
        rel = {n: _err(a, b) / max(b.float().abs().max().item(), 1e-30)
               for n, (a, b) in grads.items()}
        dkv_tol = DKV_BF16_TOL if name == "bfloat16" else tol
        emit("frontend_doc_parity", arch=tag, heads=f"{hq}/{hkv}", d=d,
             dtype=name, tol=tol, dkv_tol=dkv_tol, o_err=e_o, lse_err=e_lse,
             grad_rel_err=rel)
        if max(e_o, e_lse, rel["dq"]) > tol \
                or max(rel["dk"], rel["dv"]) > dkv_tol:
            raise AssertionError(f"doc kernels at {hq}/{hkv} heads, D {d}, "
                                 f"{name}: parity failed")
        err["flash_fwd"] = max(err["flash_fwd"], e_o)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], _err(dq, pdq))
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], _err(dk, pdk),
                                   _err(dv, pdv))
        del q, k, v, do, o, po, dq, dk, dv, pdq, pdk, pdv, grads
    return {"err": err, "times": doc_times(
        torch, timer, gen, hq, hkv, d, phase="frontend_kernel_time",
        arch=tag, heads=f"{hq}/{hkv}", head_dim=d)}


def frontend_kernels_phase(torch, timer) -> dict:
    """All five kernels at the frontends' heads, D 64: musicgen's 24 query
    heads over 24 KV heads (group 1) and internvl's 14 over 2 (group 7,
    an odd group for dK/dV's sum over the group)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    out = {}
    for arch, hq, hkv in FRONT_HEADS:
        out[arch] = {
            "decode": decode_kernel_checks(torch, timer, gen, hq, hkv,
                                           FRONT_D, arch),
            "doc": doc_kernel_checks(torch, timer, gen, hq, hkv, FRONT_D,
                                     arch)}
    return out


def frontend_train_phase(torch, arch: str) -> dict:
    """``arch`` at full width and depth, bf16 with an fp32 master, through
    ``build_train_step`` (the CLI refuses the family: no data source makes
    its inputs) for FRONT_STEPS steps of one SEQ-token wlb_llm sequence,
    the frontend keys drawn from the seed in plan order: finite losses
    and layers x (2, 1, 1) doc-kernel launches each step."""
    import math
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    L = cfg.num_layers
    params = init_params(cfg, seed=0, device="cuda")
    opt = adamw_init(params)
    step_fn = build_train_step(
        cfg, RunConfig(arch=arch, total_steps=FRONT_STEPS, warmup_steps=1),
        device="cuda")
    pipe = PipelineConfig(dataset="wlb_llm", context_len=SEQ,
                          batch_per_host=1, cp_size=1,
                          vocab_size=cfg.vocab_size, align=T_BLOCK,
                          emit_tables=True)
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for step in range(FRONT_STEPS):
        batch = make_batch(pipe, step)
        batch.update(frontend_inputs(cfg, batch["perm"], seed=100 + step))
        batch = batch_to_device(batch, "cuda")
        reset_counts()
        t0 = time.perf_counter()
        metrics = step_fn(params, opt, batch, step)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(read_counts())
    mean_s = statistics.mean(step_s[1:])
    out = {"arch": arch, "params": sum(x.numel() for x in
                                       _tree_leaves(params)),
           "layers": L, "seq_len": SEQ, "steps": FRONT_STEPS,
           "losses": losses, "step_s": step_s, "step_s_after_first": mean_s,
           "tokens_per_s": SEQ / mean_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": launches, "expected_launches": want}
    emit(f"{arch}_train", **out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: non-finite training losses")
    if any(c[n] != want[n] for c in launches for n in want):
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    return out


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def frontend_frames(cfg, prompts, seed: int):
    """Each audio prompt's own frame embeddings (None for a token
    family)."""
    import numpy as np
    if cfg.frontend != "audio_frames":
        return None
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((len(p), cfg.d_model)).astype(np.float32)
            for p in prompts]


def frontend_serve_phase(torch, arch: str) -> dict:
    """``arch`` at full width and depth serving the main path's 12
    requests on 6 slots (the audio prompts with their own frames), paged
    and dense: every request ok, the layout's decode kernel launched
    decode steps x layers times; paged vs dense identical requests
    reported; then the smoke-width f32 model on the card and on the CPU:
    the same greedy tokens on both layouts."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params

    cfg = get_config(arch)
    params = init_params(cfg, seed=0, device="cuda")
    prompts = requests(cfg)
    frames = frontend_frames(cfg, prompts, seed=7)
    kw = dict(num_slots=6, prefill_chunk=128, block_size=16)
    tokens, out = {}, {}
    for layout, kernel in (("paged", "flash_decode_paged"),
                           ("dense", "flash_decode")):
        eng, res, launches, wall, peak = serve_run(
            torch, cfg, params, layout, prompts, FRONT_GEN, frames=frames,
            **kw)
        s = eng.stats
        want = s["decode_steps"] * cfg.num_layers
        tp = eng.throughput()
        out[layout] = {"wall_s": wall, **tp, "peak_bytes": peak,
                       "launches": launches[kernel],
                       "expected_launches": want,
                       "prefill_cached_tokens": s["prefill_cached_tokens"],
                       "latency": eng.latency_percentiles()}
        emit(f"{arch}_serve_{layout}", **out[layout])
        if launches[kernel] != want or not want:
            raise AssertionError(f"{arch} {layout}: {kernel} launched "
                                 f"{launches[kernel]} times, want {want}")
        if frames is not None and s["prefill_cached_tokens"]:
            raise AssertionError(f"{arch}: audio prompts shared KV blocks")
        tokens[layout] = {r: e["tokens"] for r, e in res.items()}
        del eng
    agree = sum(int((tokens["paged"][r] == tokens["dense"][r]).all())
                for r in tokens["paged"])
    emit(f"{arch}_paged_vs_dense_tokens", identical_requests=agree,
         of=len(prompts))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small = reduce_for_smoke(cfg)
    p_cpu = init_params(small, seed=3, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    sp = requests(small, n=6, lo=20, hi=60, prefix=16, seed=4)
    sf = frontend_frames(small, sp, seed=8)
    skw = dict(num_slots=3, prefill_chunk=16, block_size=16)
    for layout in ("paged", "dense"):
        toks = {}
        for dev, prm in (("cuda", p_gpu), ("cpu", p_cpu)):
            _, res, launches, _, _ = serve_run(torch, small, prm, layout, sp,
                                               12, device=dev, frames=sf,
                                               **skw)
            toks[dev] = {r: e["tokens"].tolist() for r, e in res.items()}
            if dev == "cuda" and not sum(launches.values()):
                raise AssertionError("smoke serving launched no kernel")
        same = toks["cuda"] == toks["cpu"]
        emit(f"{arch}_smoke_cuda_vs_cpu_tokens", layout=layout,
             identical=same)
        if not same:
            raise AssertionError(f"{arch} {layout}: cuda and cpu tokens "
                                 "differ")
    return out


# ----------------------------------------------------------------------- #
# adaptive dispatch and elastic recovery over ranks sharing the card
# ----------------------------------------------------------------------- #
def dispatch_args(*extra):
    return train_args("--arch", ARCH, "--layers", str(DISPATCH_LAYERS),
                      "--seq-len", str(DISPATCH_SEQ), "--batch",
                      str(DISPATCH_BATCH), "--steps", str(DISPATCH_STEPS),
                      "--seed", str(DISPATCH_SEED), "--device", "cuda",
                      "--dispatch", "--dispatch-bin-quantum",
                      str(DISPATCH_MESH[1]), "--log-every", "1", *extra)


def dispatch_launches(degrees) -> dict:
    """Each doc kernel's launches on one rank over steps at CP
    ``degrees``: layers x degree x (2, 1, 1) a step (local + hops,
    the forward twice under remat)."""
    per = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    return {n: sum(DISPATCH_LAYERS * g * k for g in degrees)
            for n, k in per.items()}


def dispatch_rank(rank, world, backend, store, out_dir, ckpt_root):
    """One rank of the 2x2 runs, one after the other in this process:
    the dispatched run, the run that loses host 1 at step 3 and the run
    with host 1 twice as slow; each run's outcome, launch counts and
    peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(*DISPATCH_MESH, device_type="cuda")
        out = {"rank": rank}
        for name, extra in DISPATCH_RUNS:
            extra = [x.replace("{ckpt}", f"{ckpt_root}/{name}")
                     for x in extra]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            res = train(dispatch_args("--mesh", "x".join(map(str,
                                                              DISPATCH_MESH)),
                                      "--dist-backend", backend, *extra),
                        mesh=mesh, device=dev)
            counts = read_counts()
            out[name] = {
                "wall_s": time.perf_counter() - t0,
                "launches": {n: counts[n] for n in DOC_KERNELS},
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                **{k: res[k] for k in (
                    "losses", "step_s", "degrees", "targets", "mesh",
                    "accum", "dead_hosts", "recoveries", "left",
                    "degree_switches", "final_step")},
                "placements": [[d["cp_degree"], d["group_tokens"],
                                d.get("group_speeds")]
                               for d in res["dispatch"]]}
            del res
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dispatch_start(torch) -> tuple:
    """Hand :func:`dispatch_rank`'s 2x2 runs to the rank pool, whose
    ranks move their ZeRO-3 state through host memory while the card
    runs the next phases of this process; :func:`dispatch_phase` waits
    for them.  Returns (job, its checkpoint root, start time)."""
    import tempfile

    ckpt_root = tempfile.TemporaryDirectory()
    world = DISPATCH_MESH[0] * DISPATCH_MESH[1]
    return (PendingRanks(torch, dispatch_rank, world, (ckpt_root.name,)),
            ckpt_root, time.perf_counter())


def dispatch_phase(torch, pending: tuple) -> dict:
    """``--dispatch`` and the elastic supervisor on full-width
    starcoder2_3b cut to DISPATCH_LAYERS layers, bf16, 4 rows of
    DISPATCH_SEQ tokens a step, seed DISPATCH_SEED (whose CP degrees are
    1, 2, 2, 2: the ranks reshard at the switch), on a 2x2 mesh of
    ranks sharing the card; bins packed alike at every degree, so the
    data do not depend on the degree.  Gates: the dispatched run switches
    degree and its losses match one rank's run of the same stream
    (DISPATCH_LOSS_TOL); each rank's doc-kernel launches are those of
    its degrees; the run that loses host 1 (ranks 2, 3) at step 3 shrinks
    to 1x2 with accum 2 and matches the dispatched run; the one-rank run
    restarted at step 3 from its checkpoint matches the one-rank run;
    under --straggle 1:2.0 every rank makes rank 0's targets and
    placements, and none hangs.  The 2x2 runs were started by
    :func:`dispatch_start` (``pending``); the one-rank runs go here."""
    import math
    import tempfile

    def one_rank(*extra) -> dict:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(dispatch_args("--mesh", "1x1", *extra))
        out = {"wall_s": time.perf_counter() - t0,
               "launches": {n: read_counts()[n] for n in DOC_KERNELS},
               "peak_bytes": torch.cuda.max_memory_allocated(),
               **{k: res[k] for k in ("losses", "step_s", "degrees",
                                      "recoveries")}}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        return out

    job, ckpt_root, t0 = pending
    try:
        # the one-rank runs go here while the 2x2 ranks run theirs on the
        # pool
        one_out = one_rank()
        emit("dispatch_one_rank", **one_out)
        if one_out["launches"] != dispatch_launches(one_out["degrees"]):
            raise AssertionError(f"one rank launched {one_out['launches']}")
        with tempfile.TemporaryDirectory() as ckpt:
            restart = one_rank("--fail-at", "3", "--checkpoint-dir", ckpt,
                               "--ckpt-every", "2")
        ranks = job.wait(DISPATCH_TIMEOUT)
    finally:
        ckpt_root.cleanup()
    ranks_s = time.perf_counter() - t0
    restart["loss_rel_diff"] = max(
        abs(x - y) / abs(y) for x, y in zip(restart["losses"],
                                            one_out["losses"]))
    emit("dispatch_restart", **restart, tol=DISPATCH_LOSS_TOL)
    if restart["recoveries"] != 1 \
            or len(restart["losses"]) != len(one_out["losses"]) \
            or restart["loss_rel_diff"] > DISPATCH_LOSS_TOL:
        raise AssertionError(f"restart: {restart}")

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    ref = one_out["losses"]
    res = {"ranks_s": ranks_s, "one_rank": one_out, "restart": restart}
    for name, _ in DISPATCH_RUNS:
        r0 = ranks[0][name]
        res[name] = {k: r0[k] for k in (
            "wall_s", "losses", "step_s", "degrees", "targets", "mesh",
            "accum", "dead_hosts", "recoveries", "degree_switches",
            "peak_bytes", "launches")}
        res[name]["loss_rel_diff"] = rel(r0["losses"], ref) \
            if len(r0["losses"]) == len(ref) else None
        emit(f"dispatch_{name}", **res[name], tol=DISPATCH_LOSS_TOL,
             left=[x[name]["left"] for x in ranks],
             peak_bytes_by_rank=[x[name]["peak_bytes"] for x in ranks])
        if not all(math.isfinite(x) for x in r0["losses"]):
            raise AssertionError(f"{name}: non-finite losses")
    d = ranks[0]["dispatch"]
    if d["degree_switches"] < 1 or len(set(d["degrees"])) < 2:
        raise AssertionError(f"dispatch switched no degree: {d['degrees']}")
    for name in ("dispatch", "shrink"):
        r = res[name]
        if r["loss_rel_diff"] is None \
                or r["loss_rel_diff"] > DISPATCH_LOSS_TOL:
            raise AssertionError(f"{name}: losses {r['losses']} against one "
                                 f"rank's {ref}")
    for x in ranks:
        for name in ("dispatch", "straggle"):
            want = dispatch_launches(x[name]["degrees"])
            if x[name]["launches"] != want:
                raise AssertionError(f"rank {x['rank']} {name}: launches "
                                     f"{x[name]['launches']}, want {want}")
    s = [x["shrink"] for x in ranks]
    if not (all(tuple(x["mesh"]) == (1, DISPATCH_MESH[1]) and x["accum"] == 2
                and x["dead_hosts"] == [1] and x["recoveries"] == 1
                for x in s)
            and [x["left"] for x in s] == [False, False, True, True]):
        raise AssertionError(f"shrink: {s}")
    st = [x["straggle"] for x in ranks]
    if any(x[k] != st[0][k] for x in st for k in ("degrees", "targets",
                                                  "placements")) \
            or not any(p[2] for p in st[0]["placements"]):
        raise AssertionError("straggle: the ranks decided differently")
    return res


def timed(fn, *args):
    """``fn(*args)``, its wall time emitted as a ``phase_seconds`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit("phase_seconds", name=fn.__name__, seconds=time.perf_counter() - t0)
    return out


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
    built = _build.build_all()
    for source, (_, log, _) in built.items():
        print(f"== {source}\n{log}", file=sys.stderr)
    _build.flash_decode_lib()
    _build.doc_attention_lib()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={s: sec for s, (_, _, sec) in built.items()},
         sources=[KERNEL_SOURCE, DOC_SOURCE])

    timer = Timer(torch)
    kern = timed(kernel_phase, torch, timer, args.quick)
    doc = timed(doc_kernel_phase, torch, timer, args.quick)
    kernels = []
    if not args.quick:
        serving = timed(main_path_phase, torch)
        launches = {name: serving[layout]["launches"]
                    for name, layout in (("flash_decode", "dense"),
                                         ("flash_decode_paged", "paged"))}
        timed(serve_resilience_phase, torch, serving)
        decode_inputs = timed(serve_sharded_phase, torch,
                              serving)["decode_inputs"]
        del serving
        gc.collect()
        torch.cuda.empty_cache()
        timed(smoke_parity_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        trained, res = timed(train_phase, torch)
        launches.update({n: trained["launches"][n] for n in DOC_KERNELS})
        timed(step_audit_phase, torch, res)
        res["opt_state"] = None       # the parity step needs no optimizer
        gc.collect()
        torch.cuda.empty_cache()
        timed(step_parity_phase, torch, res)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        timed(smoke_train_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(cost_model_phase, torch, timer)
        gc.collect()
        torch.cuda.empty_cache()
        timed(autotune_phase, torch, trained)
        gc.collect()
        torch.cuda.empty_cache()
        timed(examples_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(cp_islands_phase, torch, decode_inputs)
        del decode_inputs
        cp = timed(cp_train_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(dp_train_phase, torch, cp["dp_one"])
        timed(dp_full_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        # the dry run traces on the pool's idle workers meanwhile
        dry = dryrun_start(torch)
        timed(moe_serve_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(moe_train_phase, torch)
        timed(dryrun_phase, torch, trained, cp["pod"], dry)
        del cp, dry
        gc.collect()
        torch.cuda.empty_cache()
        timed(moe_cp_train_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(jamba_serve_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(jamba_layers_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(jamba_smoke_phase, torch)
        timed(xlstm_train_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(rec_cp_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(xlstm_serve_phase, torch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(frontend_kernels_phase, torch, timer)
        # the dispatch phase's 2x2 ranks run on the pool meanwhile
        pending = dispatch_start(torch)
        for arch, _, _ in FRONT_HEADS:
            gc.collect()
            torch.cuda.empty_cache()
            timed(frontend_train_phase, torch, arch)
            gc.collect()
            torch.cuda.empty_cache()
            timed(frontend_serve_phase, torch, arch)
        gc.collect()
        torch.cuda.empty_cache()
        timed(dispatch_phase, torch, pending)
        del pending
        errs = {**kern["err"], **doc["err"]}
        times = {**kern["times"], **doc["times"]}
        for name in REPLACES:
            t = times[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": DOC_SOURCE if name in DOC_KERNELS
                else KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        close_rank_pool()
    sys.exit(code)
