"""Layer 1 — static plan & table verification (DESIGN.md §Static-analysis;
the port's copy of the reference's ``repro.analysis.plan_check``, over
the port's plans, encodings, tables and serving pool).

Pure host-numpy structural checks over planner outputs.  Nothing here
raises on a violation — every check returns :class:`Finding` records so
the CLI can report all problems in one pass and tests can assert on rule
ids.  The checks intentionally *re-derive* each invariant from first
principles (dense oracles, per-token expansion) rather than reusing the
planner's own accounting, so a bug in the fast vectorized path cannot
hide itself.

Rule ids: PLAN00x (shard plans), ENC00x (encodings), TAB00x (visit
tables), WQ00x (work queues), SRV00x (serve block tables).
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.doc_attention import (FLAG_FIRST, FLAG_LAST,
                                               FLAG_VALID)
from repro_torch.planner.encode import PlanEncoding
from repro_torch.planner.plan import ShardingPlan

__all__ = [
    "check_plan",
    "check_encoding",
    "check_block_tables",
    "check_work_queue",
    "check_serve_state",
]


# --------------------------------------------------------------------- #
# PLAN00x — shard plans
# --------------------------------------------------------------------- #
def check_plan(plan: ShardingPlan, *, max_imbalance: float | None = None,
               require_equal_tokens: bool = True,
               token_tolerance: int = 0,
               context: str = "plan") -> list[Finding]:
    """Structural checks on one :class:`ShardingPlan`.

    ``max_imbalance``: the planner's declared workload bound (None skips
    PLAN004 — baselines like llama3/per_doc are imbalanced by design).
    ``require_equal_tokens``/``token_tolerance``: gate PLAN003 on the
    planner's :class:`PlannerInfo` contract.
    """
    out: list[Finding] = []
    a = plan.arrays
    n_docs = len(plan.doc_lens)
    N = plan.num_workers

    # PLAN002 first: range errors would poison the coverage scan.
    bad_doc = (a.doc_id < 0) | (a.doc_id >= n_docs)
    bad_worker = (a.worker < 0) | (a.worker >= N)
    bad_len = a.length <= 0
    bad_start = a.start < 0
    for mask, what in ((bad_doc, "doc_id out of range"),
                       (bad_worker, "worker out of range"),
                       (bad_len, "non-positive shard length"),
                       (bad_start, "negative shard start")):
        if mask.any():
            i = int(np.flatnonzero(mask)[0])
            out.append(Finding(
                "PLAN002", "error", context,
                f"{what} in {int(mask.sum())} shard(s); first at shard "
                f"{i}: doc={int(a.doc_id[i])} start={int(a.start[i])} "
                f"len={int(a.length[i])} worker={int(a.worker[i])}",
                hint="planner emitted a malformed ShardArrays entry"))
    if any(f.rule == "PLAN002" for f in out):
        return out

    # PLAN001 — exact tiling: per document, shards sorted by start must
    # run 0 .. doc_len with no gap, overlap, or missing document.
    order = np.lexsort((a.start, a.doc_id))
    d, s, e = a.doc_id[order], a.start[order], a.end[order]
    covered = np.bincount(a.doc_id, weights=a.length,
                          minlength=n_docs).astype(np.int64)
    first = np.ones(len(d), dtype=bool)
    first[1:] = d[1:] != d[:-1]
    bad_first = first & (s != 0)
    step = np.zeros(len(d), bool)
    if len(d) > 1:
        step[1:] = (~first[1:]) & (s[1:] != e[:-1])
    overlap = np.zeros(len(d), bool)
    if len(d) > 1:
        overlap[1:] = (~first[1:]) & (s[1:] < e[:-1])
    for i in np.flatnonzero(bad_first)[:3]:
        out.append(Finding(
            "PLAN001", "error", context,
            f"doc {int(d[i])}: first shard starts at {int(s[i])}, "
            f"token range [0, {int(s[i])}) uncovered",
            hint="every document must be tiled from token 0"))
    for i in np.flatnonzero(step)[:3]:
        kind = "double-covered" if overlap[i] else "uncovered"
        lo, hi = sorted((int(e[i - 1]), int(s[i])))
        out.append(Finding(
            "PLAN001", "error", context,
            f"doc {int(d[i])}: tokens [{lo}, {hi}) {kind} "
            f"(shard boundary {int(e[i - 1])} vs next start {int(s[i])})",
            hint="shards of one document must tile it exactly once"))
    # tail / total coverage (catches missing docs and over-long shards)
    mismatch = np.flatnonzero(covered != plan.doc_lens)
    if not (bad_first.any() or step.any()):
        for i in mismatch[:3]:
            out.append(Finding(
                "PLAN001", "error", context,
                f"doc {int(i)}: shards cover {int(covered[i])} of "
                f"{int(plan.doc_lens[i])} tokens",
                hint="document not fully covered by its shards"))
    # last-shard end must equal doc_len even when totals happen to match
    last = np.ones(len(d), dtype=bool)
    last[:-1] = d[:-1] != d[1:]
    bad_end = last & (e != plan.doc_lens[d])
    if not (bad_first.any() or step.any() or len(mismatch)):
        for i in np.flatnonzero(bad_end)[:3]:
            out.append(Finding(
                "PLAN001", "error", context,
                f"doc {int(d[i])}: last shard ends at {int(e[i])}, "
                f"doc_len is {int(plan.doc_lens[d[i]])}",
                hint="shards of one document must tile it exactly once"))

    # PLAN003 — Eq.2 equal tokens
    if require_equal_tokens:
        tok = plan.tokens_per_worker()
        target = plan.context_len / N
        off = np.abs(tok - target)
        if (off > token_tolerance).any():
            j = int(np.argmax(off))
            out.append(Finding(
                "PLAN003", "error", context,
                f"equal-token constraint violated: worker {j} holds "
                f"{int(tok[j])} tokens, target C/N = {target:g} "
                f"(tolerance {token_tolerance})",
                hint="Eq.2: every CP rank must hold C/N tokens"))

    # PLAN004 — declared workload bound
    if max_imbalance is not None:
        imb = plan.imbalance_ratio()
        if imb > max_imbalance + 1e-9:
            out.append(Finding(
                "PLAN004", "error", context,
                f"workload imbalance {imb:.4f} exceeds declared bound "
                f"{max_imbalance:.4f}",
                hint="planner exceeded its own balance guarantee"))
    return out


# --------------------------------------------------------------------- #
# ENC00x — plan encodings
# --------------------------------------------------------------------- #
def _token_shard_is_last(plan: ShardingPlan) -> np.ndarray:
    """(C,) bool per *packed position*: does this token live in a last
    shard?  Expanded directly from the shard arrays."""
    a = plan.arrays
    doc_starts = np.concatenate([[0], np.cumsum(plan.doc_lens)])[:-1]
    C = plan.context_len
    out = np.zeros(C, dtype=bool)
    is_last = a.is_last(plan.doc_lens)
    for ds, st, ln, il in zip(doc_starts[a.doc_id], a.start, a.length,
                              is_last):
        out[int(ds + st): int(ds + st + ln)] = bool(il)
    return out


def check_encoding(plan: ShardingPlan, enc: PlanEncoding, *,
                   context: str = "encoding") -> list[Finding]:
    """ENC001-ENC005 over one (plan, encoding) pair."""
    out: list[Finding] = []
    N = plan.num_workers
    C = plan.context_len
    doc_starts = np.concatenate([[0], np.cumsum(plan.doc_lens)])[:-1]

    perm, doc, pos = enc.perm, enc.doc, enc.pos
    valid = perm >= 0

    # ENC001 — perm restricted to valid slots is a permutation of 0..C-1
    vals = np.sort(perm[valid])
    if len(vals) != C or not np.array_equal(vals, np.arange(C)):
        dup = vals[:-1][vals[1:] == vals[:-1]] if len(vals) > 1 else []
        missing = np.setdiff1d(np.arange(C), vals)
        out.append(Finding(
            "ENC001", "error", context,
            f"perm is not a permutation of 0..{C - 1}: "
            f"{len(vals)} valid entries, "
            f"{len(np.unique(vals))} distinct"
            + (f", first duplicate {int(dup[0])}" if len(dup) else "")
            + (f", first missing {int(missing[0])}" if len(missing) else ""),
            hint="every packed token must appear exactly once in plan order"))
        return out   # downstream checks need a valid perm

    if ((doc >= 0) != valid).any():
        out.append(Finding(
            "ENC002", "error", context,
            "doc >= 0 does not coincide with perm >= 0 padding",
            hint="pad slots must be -1 in both perm and doc"))

    # ENC002 — doc/pos agree with perm: packed = doc_start[doc] + pos
    recon = np.where(valid, doc_starts[np.maximum(doc, 0)] + pos, -1)
    bad = valid & (recon != perm)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        out.append(Finding(
            "ENC002", "error", context,
            f"doc/pos inconsistent with perm at plan slot {i}: "
            f"doc={int(doc[i])} pos={int(pos[i])} -> packed "
            f"{int(recon[i])}, perm says {int(perm[i])}",
            hint="encoded token metadata must match the shard layout"))

    # ---- send buffers ------------------------------------------------- #
    t_loc, buf_len = enc.t_loc, enc.buf_len
    is_last_tok = _token_shard_is_last(plan)   # per packed position
    sent_packed: list[np.ndarray] = []
    for j in range(N):
        sl = enc.send_idx[j]
        taken = sl >= 0
        li = sl[taken].astype(np.int64)
        if (li >= t_loc).any():
            out.append(Finding(
                "ENC004", "error", context,
                f"worker {j}: send_idx exceeds t_loc={t_loc}",
                hint="send indices are local to the worker's token slice"))
            continue
        plan_slots = j * t_loc + li
        if (perm[plan_slots] < 0).any():
            out.append(Finding(
                "ENC004", "error", context,
                f"worker {j}: send buffer references padding slots",
                hint="only real tokens may be sent"))
            continue
        pk = perm[plan_slots]
        sent_packed.append(pk)
        # gathered metadata must mirror the sent tokens
        gd = enc.gath_doc[j * buf_len: j * buf_len + len(sl)][taken]
        gp = enc.gath_pos[j * buf_len: j * buf_len + len(sl)][taken]
        if (gd != doc[plan_slots]).any() or (gp != pos[plan_slots]).any():
            out.append(Finding(
                "ENC002", "error", context,
                f"worker {j}: gath_doc/gath_pos disagree with the sent "
                f"tokens' doc/pos",
                hint="gathered metadata must describe the send buffer"))
        # ENC004 — Eq.5: sent tokens must all be non-last-shard tokens
        redundant = is_last_tok[pk]
        if redundant.any():
            i = int(pk[np.flatnonzero(redundant)[0]])
            out.append(Finding(
                "ENC004", "error", context,
                f"worker {j} sends {int(redundant.sum())} last-shard "
                f"token(s) (first: packed position {i}) — redundant KV "
                f"communication the paper's Eq.5 eliminates",
                hint="only non-last document shards contribute to the "
                     "exchange buffer"))

    # ENC005 — completeness: every non-last-shard token is sent once
    want = np.flatnonzero(~is_last_tok)
    got = np.concatenate(sent_packed) if sent_packed else \
        np.zeros(0, np.int64)
    got_sorted = np.sort(got)
    if len(got_sorted) != len(np.unique(got_sorted)):
        out.append(Finding(
            "ENC004", "error", context,
            "a token appears more than once across send buffers",
            hint="each non-last shard token is sent exactly once"))
    missing = np.setdiff1d(want, got_sorted)
    if len(missing):
        out.append(Finding(
            "ENC005", "error", context,
            f"{len(missing)} non-last shard token(s) missing from the "
            f"send buffers (first: packed position {int(missing[0])})",
            hint="Eq.4/5 exchange must carry every non-last shard token"))

    # ENC003 — causal closure: for each worker, every prefix position of
    # every local query token is available locally or in the gathered
    # buffers.  (doc, pos) availability via a composite-key set.
    key = np.int64(1) << 32
    gath_valid = enc.gath_doc >= 0
    gkeys = (enc.gath_doc[gath_valid].astype(np.int64) * key
             + enc.gath_pos[gath_valid])
    for j in range(N):
        sl = slice(j * t_loc, (j + 1) * t_loc)
        ld, lp = doc[sl], pos[sl]
        lv = ld >= 0
        avail = np.union1d(ld[lv].astype(np.int64) * key + lp[lv], gkeys)
        # needed: for each local (d, p), all (d, p') p' < p.  Checking
        # every prefix position is O(C^2) worst case; instead verify the
        # equivalent interval condition per doc: available positions of
        # doc d on this worker must cover [0, max_local_pos(d)].
        for dd in np.unique(ld[lv]):
            need_hi = int(lp[lv][ld[lv] == dd].max())
            have = np.sort(avail[(avail >= dd * key)
                                 & (avail < (dd + 1) * key)] - dd * key)
            # positions present for doc dd (local + gathered)
            cover = np.searchsorted(have, np.arange(need_hi + 1))
            present = (cover < len(have)) & \
                (have[np.minimum(cover, len(have) - 1)]
                 == np.arange(need_hi + 1))
            if not present.all():
                p_miss = int(np.flatnonzero(~present)[0])
                out.append(Finding(
                    "ENC003", "error", context,
                    f"worker {j}, doc {int(dd)}: query at position "
                    f"{need_hi} cannot see prefix position {p_miss} "
                    f"(neither local nor gathered)",
                    hint="causal closure: the exchange must deliver every "
                         "remote prefix KV"))
                break
    return out


# --------------------------------------------------------------------- #
# TAB00x — visit tables vs. a dense token-level oracle
# --------------------------------------------------------------------- #
def check_block_tables(q_doc, q_pos, kv_doc, kv_pos, kv_idx, kv_nvis, *,
                       block_q: int, block_k: int,
                       context: str = "tables") -> list[Finding]:
    """Soundness of one (possibly batched) rectangular visit table.

    ``q_doc``/``q_pos`` (B, Tq) and ``kv_doc``/``kv_pos`` (B, Tk) are the
    token metadata the table was built from; ``kv_idx`` (B, R, V) /
    ``kv_nvis`` (B, R) the table under test.  The oracle is the exact
    token-level visibility ``same doc AND kv_pos <= q_pos AND both
    valid``: every KV block containing at least one visible pair for a
    query block must appear in that block-row's visit list (TAB001).
    Over-visiting is sound (the kernel masks per token) and is not
    flagged.  TAB002 checks index ranges and padding discipline.
    """
    q_doc = np.asarray(q_doc)
    q_pos = np.asarray(q_pos)
    kv_doc = np.asarray(kv_doc)
    kv_pos = np.asarray(kv_pos)
    kv_idx = np.asarray(kv_idx)
    kv_nvis = np.asarray(kv_nvis)
    out: list[Finding] = []
    B, R, V = kv_idx.shape
    nk = kv_doc.shape[-1] // block_k

    # TAB002 — ranges
    if (kv_nvis < 0).any() or (kv_nvis > nk).any():
        out.append(Finding(
            "TAB002", "error", context,
            f"kv_nvis outside [0, {nk}]",
            hint="visit counts must not exceed the KV block count"))
    lane = np.arange(V)[None, None, :]
    used = lane < np.minimum(kv_nvis, V)[..., None]
    if ((kv_idx < 0) & used).any() or ((kv_idx >= nk) & used).any():
        out.append(Finding(
            "TAB002", "error", context,
            f"kv_idx entry outside [0, {nk}) within the visited prefix",
            hint="visit entries must be valid KV block ids"))
    if out:
        return out

    for b in range(B):
        vis = ((q_doc[b][:, None] == kv_doc[b][None, :])
               & (q_doc[b][:, None] >= 0) & (kv_doc[b][None, :] >= 0)
               & (kv_pos[b][None, :] <= q_pos[b][:, None]))
        # block-level any-visible oracle
        blk = vis.reshape(R, block_q, nk, block_k).any((1, 3))
        for r in range(R):
            need = np.flatnonzero(blk[r])
            have = kv_idx[b, r, :kv_nvis[b, r]]
            missing = np.setdiff1d(need, have)
            if len(missing):
                out.append(Finding(
                    "TAB001", "error", context,
                    f"sample {b} q-block {r}: visible KV block(s) "
                    f"{missing[:4].tolist()} not in the visit list — the "
                    f"kernel would silently skip attention mass",
                    hint="table build must be conservative: visit any "
                         "block with one visible pair"))
                if len(out) > 8:
                    return out
    return out


# --------------------------------------------------------------------- #
# WQ00x — flattened work queues
# --------------------------------------------------------------------- #
def check_work_queue(idx, nvis, row, col, flags, *,
                     context: str = "queue") -> list[Finding]:
    """WQ001-WQ003 over one (B, S) work-queue triple against the
    rectangular tables it was flattened from."""
    idx = np.asarray(idx)
    nvis = np.asarray(nvis).astype(np.int64)
    row = np.asarray(row)
    col = np.asarray(col)
    flags = np.asarray(flags)
    out: list[Finding] = []
    B, R, V = idx.shape
    S = row.shape[1]

    for b in range(B):
        nv = nvis[b]
        counts = np.maximum(nv, 1)
        total = int(counts.sum())
        if total > S:
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"queue too short: needs {total} steps, has {S}",
                hint="pad_to_steps below the real step count"))
            continue
        r = row[b, :total]
        f = flags[b, :total]
        c = col[b, :total]

        # rows must form contiguous runs covering every row once
        run_start = np.ones(total, dtype=bool)
        run_start[1:] = r[1:] != r[:-1]
        starts = np.flatnonzero(run_start)
        run_rows = r[starts]
        if len(np.unique(run_rows)) != R or len(run_rows) != R:
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"rows do not form one contiguous run each: "
                f"{len(run_rows)} runs over {R} rows",
                hint="each block-row's steps must be contiguous"))
            continue
        run_len = np.diff(np.append(starts, total))
        bad_len = run_len != counts[run_rows]
        if bad_len.any():
            rr = int(run_rows[np.flatnonzero(bad_len)[0]])
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"row {rr}: run length {int(run_len[run_rows == rr][0])} "
                f"!= expected {int(counts[rr])}",
                hint="one step per visit, one sentinel for empty rows"))

        # flags: FIRST exactly at run starts, LAST exactly at run ends
        ends = np.append(starts[1:], total) - 1
        first_mask = np.zeros(total, dtype=bool)
        first_mask[starts] = True
        last_mask = np.zeros(total, dtype=bool)
        last_mask[ends] = True
        if (((f & FLAG_FIRST) != 0) != first_mask).any():
            i = int(np.flatnonzero(((f & FLAG_FIRST) != 0)
                                   != first_mask)[0])
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"FLAG_FIRST mismatch at step {i} (row {int(r[i])}): "
                f"accumulators would {'not be reset' if first_mask[i] else 'be clobbered mid-row'}",
                hint="FIRST must mark exactly each row's first step"))
        if (((f & FLAG_LAST) != 0) != last_mask).any():
            i = int(np.flatnonzero(((f & FLAG_LAST) != 0)
                                   != last_mask)[0])
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"FLAG_LAST mismatch at step {i} (row {int(r[i])}): "
                f"output block would "
                f"{'never be written' if last_mask[i] else 'be finalized early'}",
                hint="LAST must mark exactly each row's final step"))
        # VALID count per row == nvis; sentinels carry no VALID
        vcount = np.bincount(r[(f & FLAG_VALID) != 0], minlength=R)
        if (vcount != nv).any():
            rr = int(np.flatnonzero(vcount != nv)[0])
            out.append(Finding(
                "WQ001", "error", f"{context} sample {b}",
                f"row {rr}: {int(vcount[rr])} VALID steps, table says "
                f"{int(nv[rr])} visits",
                hint="every visit gets exactly one VALID step; sentinels "
                     "none"))

        # pad tail: zero flags, repeat-last row/col
        if total < S:
            tf = flags[b, total:]
            if (tf != 0).any():
                out.append(Finding(
                    "WQ001", "error", f"{context} sample {b}",
                    "pad tail carries nonzero flags",
                    hint="pad steps must be no-ops (flags 0)"))
            if (row[b, total:] != r[total - 1]).any() or \
                    (col[b, total:] != c[total - 1]).any():
                out.append(Finding(
                    "WQ001", "warning", f"{context} sample {b}",
                    "pad tail does not repeat the final step",
                    hint="repeat-last padding keeps prefetch in range"))

        # WQ002 — LPT: run visit counts non-increasing, ties by row asc
        rnv = nv[run_rows]
        dec = np.flatnonzero(rnv[1:] > rnv[:-1])
        if len(dec):
            i = int(dec[0])
            out.append(Finding(
                "WQ002", "error", f"{context} sample {b}",
                f"rows not in LPT order: run {i + 1} (row "
                f"{int(run_rows[i + 1])}, {int(rnv[i + 1])} visits) after "
                f"run {i} (row {int(run_rows[i])}, {int(rnv[i])})",
                hint="longest block-rows must schedule first"))
        ties = np.flatnonzero((rnv[1:] == rnv[:-1])
                              & (run_rows[1:] < run_rows[:-1]))
        if len(ties):
            out.append(Finding(
                "WQ002", "error", f"{context} sample {b}",
                f"unstable LPT tie-break at run {int(ties[0]) + 1}",
                hint="equal-count rows must keep ascending row order "
                     "(stable sort) for deterministic schedules"))

        # WQ003 — valid steps visit exactly the rectangular visit set
        vmask = (f & FLAG_VALID) != 0
        got = set(zip(r[vmask].tolist(), c[vmask].tolist()))
        want = set()
        for rr in range(R):
            want.update((rr, int(idx[b, rr, k]))
                        for k in range(int(nv[rr])))
        if got != want:
            extra = sorted(got - want)[:3]
            miss = sorted(want - got)[:3]
            out.append(Finding(
                "WQ003", "error", f"{context} sample {b}",
                f"queue visit set != table visit set "
                f"(missing {miss}, extra {extra})",
                hint="flattening must preserve the visit set exactly"))
    return out


# --------------------------------------------------------------------- #
# SRV00x — serve block tables vs. pool / prefix cache
# --------------------------------------------------------------------- #
def check_serve_state(pool, tables: dict, prefix=None, *,
                      extra_refs: dict[int, int] | None = None,
                      context: str = "serve") -> list[Finding]:
    """Refcount / aliasing conservation over a serve snapshot.

    ``tables`` maps a request key to its block-id list; ``prefix`` is the
    optional :class:`repro_torch.serve.prefix.PrefixCache`; ``extra_refs``
    accounts engine-held references outside the tables (e.g. blocks
    retained for an in-flight copy-on-write).
    """
    out: list[Finding] = []
    extra_refs = extra_refs or {}
    nb = pool.num_blocks

    uses: dict[int, int] = {}
    holders: dict[int, list] = {}
    for key, blocks in tables.items():
        for bid in blocks:
            b = int(bid)
            if b < 0 or b >= nb:
                out.append(Finding(
                    "SRV003", "error", context,
                    f"request {key!r} references block {b} outside the "
                    f"pool [0, {nb})",
                    hint="table entries must be live pool block ids"))
                continue
            uses[b] = uses.get(b, 0) + 1
            holders.setdefault(b, []).append(key)

    cache_bids = set()
    if prefix is not None:
        cache_bids = set(prefix._by_key.values())

    free = list(pool._free)
    free_set = set(free)
    if len(free) != len(free_set):
        out.append(Finding(
            "SRV002", "error", context,
            "free list contains duplicate block ids",
            hint="double-free: a block was released below refcount 0"))

    for b in range(nb):
        ref = pool.refcount(b)
        expect = uses.get(b, 0) + (1 if b in cache_bids else 0) \
            + int(extra_refs.get(b, 0))
        if ref != expect:
            out.append(Finding(
                "SRV002", "error", context,
                f"block {b}: refcount {ref} != {expect} "
                f"({uses.get(b, 0)} table use(s)"
                f"{' + prefix cache' if b in cache_bids else ''}"
                f"{f' + {extra_refs[b]} engine ref(s)' if b in extra_refs else ''})",
                hint="leaked or dangling reference; check retain/release "
                     "pairing"))
        if (ref == 0) != (b in free_set):
            out.append(Finding(
                "SRV002", "error", context,
                f"block {b}: refcount {ref} but "
                f"{'on' if b in free_set else 'not on'} the free list",
                hint="free list must hold exactly the refcount-0 blocks"))
        if b in uses and b in free_set:
            out.append(Finding(
                "SRV003", "error", context,
                f"block {b} is referenced by {holders[b]!r} while on the "
                f"free list — a new allocation would corrupt live KV",
                hint="release order bug: tables must drop blocks before "
                     "they are freed"))

    # SRV001 — cross-request sharing requires a prefix-trie entry
    for b, hs in holders.items():
        if len(set(map(str, hs))) > 1 and b not in cache_bids:
            out.append(Finding(
                "SRV001", "error", context,
                f"block {b} shared by requests {sorted(map(str, hs))!r} "
                f"without a prefix-cache entry — decode writes would "
                f"cross-contaminate KV",
                hint="only prefix-cache hits may alias blocks across "
                     "requests"))
    return out
