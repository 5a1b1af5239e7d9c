"""Deterministic training batches at one device (the port of the
reference's ``repro.data.pipeline`` for ``cp_size == 1``).

Per batch, per packed sequence: draw document lengths from the dataset
distribution, lay the tokens out in plan order, synthesize tokens and
next-token labels, and (for the kernels) emit the visit tables.  At one
CP rank every planner keeps the packed order, so the plan order is the
identity and no KV is exchanged: ``doc``/``pos`` come straight from
:func:`~repro_torch.data.packing.doc_ids_and_positions`, padded to
``align``, and the Eq.-5 send buffers are empty.  The stream for
(seed, dp_rank, step) draws from the same seeded ``PCG64`` as the
reference, in the same order, so batches match it bit for bit.

The planners, the plan cache, ``cp_size > 1``, a fixed Eq.-5 bucket,
global dispatch and the background Prefetcher wait for the CP slice of
the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.cp_attention import resolve_overlap
from repro_torch.planner.encode import emit_visit_tables, pick_buffer_bucket
from .distributions import make_rng
from .packing import doc_ids_and_positions, pack_sequence

__all__ = ["PipelineConfig", "make_batch", "EXEC_STYLE"]

#: execution style of each planner name (the reference's registry
#: metadata ``PlannerInfo.exec_style``)
EXEC_STYLE = {"flashcp": "flashcp", "bnb": "flashcp", "ilp": "flashcp",
              "contiguous": "contiguous", "llama3": "allgather",
              "per_doc": "allgather", "ring_zigzag": "ring",
              "ring": "ring"}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataset: str = "wlb_llm"
    context_len: int = 131072
    batch_per_host: int = 1
    cp_size: int = 1
    strategy: str = "flashcp"
    vocab_size: int = 50304
    seed: int = 0
    align: int = 128             # T_loc alignment (kernel block size)
    # visit-table emission (attention_impl="flash" steps)
    emit_tables: bool = False
    table_overlap: str = "chunked"   # matches RunConfig.cp_overlap
    table_grid: str = "flat"         # matches RunConfig.kernel_grid
    table_block_q: int = 128
    table_block_k: int = 128


def exec_style_of(strategy: str) -> str:
    try:
        return EXEC_STYLE[strategy]
    except KeyError:
        raise KeyError(f"unknown CP strategy {strategy!r}; have "
                       f"{sorted(EXEC_STYLE)}") from None


def _aligned(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align if align > 1 else x


def _synthesize_row(tokens_row, labels_row, lens, perm, rng,
                    vocab_size: int) -> None:
    """Synthesize one sequence's tokens in packed order, then permute to
    plan order.  Zipfian unigrams + repetition bigrams; one zipf + one
    uniform draw per sequence (the draw order is part of the pipeline's
    determinism contract)."""
    n_tok = int(lens.sum())
    packed = ((rng.zipf(1.3, n_tok) - 1) % vocab_size
              ).astype(np.int32)
    rep = rng.random(n_tok) < 0.25
    rep[0] = False
    idx = np.arange(n_tok)
    prev = np.maximum(idx - 1, 0)
    packed = np.where(rep, packed[prev], packed)
    valid = perm >= 0
    tokens_row[valid] = packed[perm[valid]]
    # next-token labels: valid unless last token of its document
    nxt = perm + 1
    is_final = np.zeros_like(valid)
    ends = np.cumsum(lens) - 1
    is_final[valid] = np.isin(perm[valid], ends)
    lab_ok = valid & ~is_final
    labels_row[lab_ok] = packed[np.minimum(nxt[lab_ok],
                                           len(packed) - 1)]


def _synthesize_tokens(doc_lens_list, perm_stack, rng,
                       vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Batch token synthesis from one shared Generator, rows in order."""
    B, C_pad = perm_stack.shape
    tokens = np.full((B, C_pad), -1, np.int32)
    labels = np.full((B, C_pad), -1, np.int32)
    for b, lens in enumerate(doc_lens_list):
        _synthesize_row(tokens[b], labels[b], lens, perm_stack[b], rng,
                        vocab_size)
    return tokens, labels


def _encode_single_rank(doc_lens_list, context_len: int,
                        align: int) -> dict[str, np.ndarray]:
    """The plan encoding at one rank: identity permutation, doc/pos in
    packed order padded to ``align`` (doc -1, pos 0, perm -1), and empty
    Eq.-5 send buffers of the smallest bucket."""
    B = len(doc_lens_list)
    t_loc = _aligned(context_len, align)
    buf = pick_buffer_bucket(0, t_loc)
    perm = np.full((B, t_loc), -1, np.int64)
    doc = np.full((B, t_loc), -1, np.int32)
    pos = np.zeros((B, t_loc), np.int32)
    for b, lens in enumerate(doc_lens_list):
        d, p = doc_ids_and_positions(lens)
        perm[b, :len(d)] = np.arange(len(d))
        doc[b, :len(d)] = d
        pos[b, :len(d)] = p
    return {"perm": perm, "doc": doc, "pos": pos,
            "send_idx": np.full((B, 1, buf), -1, np.int32),
            "gath_doc": np.full((B, buf), -1, np.int32),
            "gath_pos": np.zeros((B, buf), np.int32)}


def _emit_tables(cfg: PipelineConfig, stack: dict,
                 num_workers: int) -> dict[str, np.ndarray]:
    style = exec_style_of(cfg.strategy)
    needs_gath = style in ("flashcp", "contiguous")
    overlap = resolve_overlap(style, "flash", cfg.table_overlap)
    return emit_visit_tables(
        stack["doc"], stack["pos"],
        stack["gath_doc"] if needs_gath else None,
        stack["gath_pos"] if needs_gath else None,
        num_workers=num_workers, strategy=style,
        overlap=overlap, grid=cfg.table_grid,
        block_q=cfg.table_block_q, block_k=cfg.table_block_k)


def make_batch(cfg: PipelineConfig, step: int,
               dp_rank: int = 0) -> dict[str, Any]:
    """Build one host-local batch for (step, dp_rank)."""
    if cfg.cp_size != 1:
        raise NotImplementedError(
            f"cp_size={cfg.cp_size}: planning and encoding for context "
            "parallelism over several ranks come with the CP slice of the "
            "port")
    exec_style_of(cfg.strategy)
    rng = make_rng(hash((cfg.seed, dp_rank, step)) % (2 ** 63))
    doc_lens_list = [pack_sequence(cfg.dataset, cfg.context_len, rng)
                     for _ in range(cfg.batch_per_host)]
    stack = _encode_single_rank(doc_lens_list, cfg.context_len, cfg.align)
    tokens, labels = _synthesize_tokens(doc_lens_list, stack["perm"], rng,
                                        cfg.vocab_size)
    batch = dict(stack)
    if cfg.emit_tables:
        batch.update(_emit_tables(cfg, stack, 1))
    batch["tokens"] = tokens
    batch["labels"] = labels
    batch["stats"] = {
        "comm_tokens": 0, "buf_len": stack["gath_doc"].shape[1],
        "t_loc": stack["doc"].shape[1], "imbalance": 1.0,
        "num_docs": float(np.mean([len(l) for l in doc_lens_list]))}
    return batch
