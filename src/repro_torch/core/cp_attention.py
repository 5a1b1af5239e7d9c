"""Context-parallel attention islands on ``torch.distributed`` (the port
of the reference's ``repro.core.cp_attention``).

Every strategy runs on the partial-attention + online-LSE merge
substrate (:mod:`repro_torch.core.merge`): attention against a KV subset
yields a merge-ready partial ``(o, m, l)``, and the flash kernels' ``(o,
lse)`` form is the triple ``(o, m=lse, l=1)``.  Strategies differ in
which KV subsets exist and how they move between the N ranks of the CP
group (:mod:`repro_torch.core.comm`):

* ``flashcp`` / ``contiguous`` — sharding-aware communication: only the
  compacted non-last-shard KV buffer (Eq. 5) moves.  ``overlap="chunked"``
  (default) moves it in N-1 ring hops: hop 1 is started before the
  local-KV partial, and each arriving buffer is forwarded before it is
  attended, so the next hop is in flight during this hop's attention.
  ``overlap="none"`` all-gathers the buffers and attends ``[local |
  gathered]`` once, with this rank's own gathered segment masked as doc
  -2 (those keys are already local).
* ``allgather`` (Llama3 and Per-Doc CP) — the full local KV is the
  payload, hopped (chunked) or all-gathered (none).
* ``ring`` — Ring Attention: chunked is the gather engine above;
  ``overlap="none"`` is the plain rotation loop (the reference's seed
  island), which has no kernel form, so ring + flash always runs chunked.

Each rank holds its slice exactly as the reference's ``shard_map``
specs give it: q/k/v and doc/pos split along tokens (worker j owns plan
positions ``[j t_loc, (j+1) t_loc)``), ``send_idx`` and the per-rank
visit tables split along their rank axis, ``gath_doc``/``gath_pos``
replicated.  The backward is autograd through the hops and gathers:
each hop sends its cotangent back along the inverse permutation, and
the all-gather's backward is a reduce-scatter.

``kv_comm_dtype="int8"`` (the reference's quantized KV wire) sends K and
V on the int8 wire of :mod:`repro_torch.core.comm` wherever an island
moves them by hop or all-gather (every island but the plain ring loop,
as in the reference); doc/pos metadata stays native.  A hop
re-quantizes the dequantized buffer it forwards, as the reference's
``_wire_permute`` does.  The backward is the native wire's, so the
gradients are exact at the dequantized K/V.

``impl`` picks the kernel: ``"flash"`` runs the CUDA training kernels in
partial mode over the pipeline's ``tab_*`` visit tables (the reference's
``"pallas"``); ``"plain"`` the chunked dense attention (its ``"xla"``).
At N = 1 no communication happens and no process group is needed.

MoE layers run the **expert-parallel island** (``extras["ep_dispatch"]``,
the reference's ``_moe_island``): each rank routes its own tokens into
capacity-clipped per-expert buffers, with the capacity of its *own*
token count, and one all-to-all over the CP group carries each expert's
slices to the rank that holds that expert (the experts are split over
the ``model`` axis); the expert FFNs run there, and a second all-to-all
brings the outputs home for the weighted combine.  ``extras
["token_sum"]`` sums a routing statistic over ``world`` (every rank of
the batch), so the aux loss is that of the whole batch.

The recurrent mixers (Mamba, mLSTM, sLSTM) run the **scan islands**
(the reference's ``_ssm_island`` and ``_selective_scan_island``): each
rank scans its own tokens from a zero state, the ranks all-gather one
(decay product, final state) summary each, and each rank folds the
summaries of the ranks before it into its carry-in, so the
communication is O(state) and no rank waits for another's scan.  The
all-gather's backward is the reduce-scatter that carries each carry-in's
cotangent back to the ranks it came from.  Where the reference shifts
a global array by a few positions (Mamba's causal convolution reads the
``d_conv - 1`` tokens before each token, the mLSTM the chunk state
before each chunk), its GSPMD partitioner exchanges a halo between
ranks; here ``extras["halo"]`` brings the previous rank's last entries
in one ring hop (zeros at rank 0), and a rank would otherwise see zeros
there.  All of these carry state in rank order, which is token order
only under an order-preserving planner (``contiguous``): the recurrent
families train on it (``launch.steps.effective_strategy``).
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.models.context import (ExecContext, local_selective_scan,
                                        local_ssm_scan)
from repro_torch.table_layout import table_keys
from .comm import (CPComm, all_gather_tiled, all_reduce_sum,
                   all_to_all_tiled, hop_start, hop_wait, int8_all_gather)
from .merge import NEG, _merge_step, finalize_partial

__all__ = ["make_cp_context", "resolve_overlap", "STRATEGIES"]

#: execution strategies the step builders hand to the context
STRATEGIES = ("flashcp", "contiguous", "allgather", "llama3", "per_doc",
              "ring", "ring_zigzag")
_FLASHCP = ("flashcp", "contiguous")


def resolve_overlap(strategy: str, impl: str, overlap: str) -> str:
    """Effective overlap mode for (strategy, impl).  Ring has no
    monolithic kernel form, so ring + flash upgrades ``"none"`` to
    ``"chunked"``; the one rule for table emission and the context."""
    if overlap not in ("none", "chunked"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    if strategy in ("ring", "ring_zigzag") and impl == "flash":
        return "chunked"
    return overlap


# ===================================================================== #
# attention against one KV set
# ===================================================================== #
def _take_tokens(x, idx):
    """x (b, H, T, D); idx (b, S) with -1 padding -> (b, H, S, D), zeroed
    at padding."""
    b, H, _, D = x.shape
    safe = idx.clamp(min=0).long()[:, None, :, None].expand(b, H, -1, D)
    return torch.gather(x, 2, safe) * (idx >= 0)[:, None, :, None].to(x.dtype)


def _partial_masked_attention(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *,
                              impl, scale, q_chunk, tables=None,
                              block_q=128, block_k=128, grid="rect"):
    """Merge-ready partial against one KV subset, on either kernel.

    The flash kernels emit ``(o, lse)``, re-expressed as ``(o, m=lse,
    l=1)``.  ``lse`` is clamped to the finite ``NEG`` so empty rows weigh
    exp(NEG - M) = 0 in a merge, and the clamp's gradient drops their
    cotangent (-inf lies below the clamp)."""
    from repro_torch.kernels import ops as kops

    if impl == "flash":
        if tables is None:
            raise ValueError("flash CP attention needs host visit tables")
        o, lse = kops.doc_flash_attention(
            q, k, v, q_doc, q_pos, kv_doc, kv_pos, tables, scale=scale,
            block_q=block_q, block_k=block_k, grid=grid, partial=True)
        m = torch.clamp(lse, min=NEG)
        return o.float(), m, torch.ones_like(m)
    return kops.doc_attention_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                                    scale=scale, q_chunk=q_chunk,
                                    partial=True)


def _masked_attention(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *, impl,
                      q_chunk, tables=None, block_q=128, block_k=128,
                      grid="rect"):
    """Normalized attention over one KV set, on either kernel."""
    from repro_torch.kernels import ops as kops

    if impl == "flash":
        if tables is None:
            raise ValueError("flash CP attention needs host visit tables")
        return kops.doc_flash_attention(q, k, v, q_doc, q_pos, kv_doc,
                                        kv_pos, tables, block_q=block_q,
                                        block_k=block_k, grid=grid)
    return kops.doc_attention_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                                    q_chunk=q_chunk)


# ===================================================================== #
# chunked exchange: attend each arriving buffer while the next one flies
# ===================================================================== #
def _run_hops(comm, init_fn, payload, n_hops, attend, hop_tables=None,
              int8=False):
    """Ring-rotate ``payload = (kc, vc, dc, pc)`` for ``n_hops`` hops,
    merging ``attend(kc, vc, dc, pc, tables)`` partials onto
    ``init_fn()`` (the local-KV partial); ``int8`` sends kc and vc on the
    int8 wire.

    Hop 1 is started before ``init_fn`` runs, so it flies under the local
    partial; each arrived buffer is forwarded before it is attended, so
    hop h+1 flies under hop h's attention.  The last buffer is attended
    and not forwarded: ``n_hops`` buffer hops in all, the bytes of the
    monolithic all-gather.  After hop h (from 1) a rank holds the payload
    of rank (me - h) mod N, whose tables are ``hop_tables[:, h - 1]``."""
    if n_hops <= 0:
        return init_fn()
    handle = hop_start(comm, payload, int8=int8)
    acc = init_fn()
    for h in range(n_hops):
        cur = hop_wait(handle)
        if h + 1 < n_hops:
            handle = hop_start(comm, cur, int8=int8)
        tabs = None if hop_tables is None else \
            tuple(t[:, h].contiguous() for t in hop_tables)
        acc = _merge_step(acc, attend(*cur, tabs))
    return acc


# ===================================================================== #
# islands (one rank's view)
# ===================================================================== #
def _flashcp_island_chunked(q, k, v, doc, pos, sidx, gath_doc, gath_pos, *,
                            comm, attend, loc_tables, hop_tables, int8):
    """The Eq.-5 buffer in N-1 hops.  The N-1 hops visit exactly the
    other ranks, so no self-segment masking is needed."""
    if comm is None:                 # one rank: the local partial alone
        return finalize_partial(attend(k, v, doc, pos, loc_tables), q.dtype)
    N, me, buf = comm.size, comm.rank, sidx.shape[-1]
    payload = (_take_tokens(k, sidx), _take_tokens(v, sidx),
               gath_doc[:, me * buf:(me + 1) * buf].contiguous(),
               gath_pos[:, me * buf:(me + 1) * buf].contiguous())
    part = _run_hops(
        comm, lambda: attend(k, v, doc, pos, loc_tables), payload, N - 1,
        attend, hop_tables, int8)
    return finalize_partial(part, q.dtype)


def _kv_gather(int8: bool):
    return int8_all_gather if int8 else all_gather_tiled


def _flashcp_island(q, k, v, doc, pos, sidx, gath_doc, gath_pos, *, comm,
                    masked, tables, int8):
    """The Eq.-5 buffers all-gathered, attended once beside the local KV;
    this rank's own gathered segment is masked as doc -2."""
    me = 0 if comm is None else comm.rank
    buf = sidx.shape[-1]
    ksel, vsel = _take_tokens(k, sidx), _take_tokens(v, sidx)
    if comm is not None:
        gather = _kv_gather(int8)
        ksel, vsel = gather(ksel, comm, 2), gather(vsel, comm, 2)
    seg = torch.arange(gath_doc.shape[1], device=gath_doc.device) // buf
    gdoc = torch.where((seg == me)[None, :], -2, gath_doc)
    return masked(q, torch.cat([k, ksel], 2), torch.cat([v, vsel], 2),
                  doc, pos, torch.cat([doc, gdoc], 1).contiguous(),
                  torch.cat([pos, gath_pos], 1).contiguous(), tables=tables)


def _allgather_island(q, k, v, doc, pos, *, comm, masked, tables, int8):
    """Full-KV all-gather (Eq. 4), attended once."""
    if comm is not None:
        gather = _kv_gather(int8)
        k, v = gather(k, comm, 2), gather(v, comm, 2)
        kd, kp = (all_gather_tiled(t, comm, 1) for t in (doc, pos))
    else:
        kd, kp = doc, pos
    return masked(q, k, v, doc, pos, kd, kp, tables=tables)


def _gather_island_chunked(q, k, v, doc, pos, *, comm, attend, loc_tables,
                           hop_tables, int8):
    """Full local KV ring-rotated in N-1 hops on the merge substrate."""
    N = 1 if comm is None else comm.size
    part = _run_hops(comm, lambda: attend(k, v, doc, pos, loc_tables),
                     (k, v, doc, pos), N - 1, attend, hop_tables, int8)
    return finalize_partial(part, q.dtype)


def _ring_island(q, k, v, doc, pos, *, comm, q_chunk, scale):
    """The plain Ring-Attention loop (``overlap="none"``): attend the
    held KV, then pass it on, N times.  The reference rotates once more
    after the last attention, which returns every buffer to its owner
    and changes no result; that rotation is skipped."""
    N = 1 if comm is None else comm.size
    b, Hq, T, D = q.shape
    acc = (torch.zeros((b, Hq, T, D), dtype=torch.float32, device=q.device),
           torch.full((b, Hq, T), NEG, dtype=torch.float32, device=q.device),
           torch.zeros((b, Hq, T), dtype=torch.float32, device=q.device))
    cur = (k, v, doc, pos)
    for step in range(N):
        part = _partial_masked_attention(
            q, cur[0], cur[1], doc, pos, cur[2], cur[3], impl="plain",
            scale=scale, q_chunk=q_chunk)
        acc = _merge_step(acc, part)
        if step + 1 < N:
            cur = hop_wait(hop_start(comm, cur))
    return finalize_partial(acc, q.dtype)


def _moe_island(x, topi, gates, wi, wg, wo, *, comm, kind, capacity_factor,
                top_k):
    """Expert-parallel dispatch of this rank's tokens: local capacity-
    clipped routing buffers exchanged by all-to-all over the CP group
    (rank r holds experts [r E/N, (r+1) E/N)), the FFN of the experts
    this rank holds, all-to-all back, local weighted combine."""
    from repro_torch.models.moe import (capacity, combine_local,
                                        dispatch_local, expert_ffn)

    b, t, d = x.shape
    E = wi.shape[0] * comm.size
    n = b * t
    cap = capacity(n, E, top_k, capacity_factor)
    buf, slot, tok_s, gat_s, keep = dispatch_local(
        x.reshape(n, d), topi.reshape(n, -1), gates.reshape(n, -1), E, cap)
    # (E, cap, d) -> rank r gets every rank's slices of its E/N experts:
    # (E/N, N cap, d)
    buf = all_to_all_tiled(buf, comm, 0, 1)
    y = expert_ffn(buf, wi, wg, wo, kind)
    y = all_to_all_tiled(y, comm, 1, 0)                      # (E, cap, d)
    return combine_local(y, slot, tok_s, gat_s, keep, n).reshape(b, t, d)


def _gathered(x, comm: CPComm):
    """Every rank's ``x`` stacked on a new leading axis (N, ...), in rank
    order (``jax.lax.all_gather(x, axis=0)``); backward reduce-scatter."""
    return all_gather_tiled(x[None].contiguous(), comm, 0)


def _carry_in(gA, gS, me: int):
    """The state entering rank ``me``: the ranks before it folded in
    order, S <- S_j + A_j S from a zero state.  Every rank's summary
    enters the graph, selected away where j >= me (as the reference's
    ``jnp.where``), so every rank's backward runs the reduce-scatter."""
    S = torch.zeros_like(gS[0])
    for j in range(gS.shape[0]):
        take = torch.tensor(j < me, device=S.device)
        S = torch.where(take, gS[j] + gA[j] * S, S)
    return S


def _selective_scan_island(dt, A, Bm, Cm, xf, reset, *, comm):
    """The chunked selective scan with the CP rank hand-off: pass 1 makes
    this rank's (decay product, final state) summary, the summaries are
    all-gathered and folded into this rank's initial state, and pass 2
    produces y from it (:func:`~repro_torch.models.context.
    local_selective_scan`)."""
    A_rank, S_rank = local_selective_scan(dt, A, Bm, Cm, xf, reset,
                                          summary_only=True)
    S0 = _carry_in(_gathered(A_rank, comm), _gathered(S_rank, comm),
                   comm.rank)
    return local_selective_scan(dt, A, Bm, Cm, xf, reset, init_state=S0)


def _ssm_island(a, x, *, comm):
    """The cross-rank recurrence h_t = a_t h_{t-1} + x_t: the local scan,
    plus the carry-in of the ranks before this one through the running
    decay (kept at ``a``'s, possibly singleton, shape)."""
    h_loc = local_ssm_scan(a, x)
    cum_a = local_ssm_scan(a, torch.zeros_like(a),
                           init=torch.ones_like(a[:, 0]))
    H_prev = _carry_in(_gathered(cum_a[:, -1], comm),
                       _gathered(h_loc[:, -1], comm), comm.rank)
    return h_loc + cum_a * H_prev[:, None]


def _make_halo(comm: CPComm):
    """``halo(x, n)``: the last ``n`` entries along axis 1 of the
    previous rank's ``x`` (B, T, ...), zeros at rank 0.  One ring hop;
    its backward sends the cotangent back to the sender (rank 0's,
    zeroed, still goes, so every rank's backward exchanges)."""
    def halo(x, n):
        if x.shape[1] < n:
            raise ValueError(f"{x.shape[1]} entries a rank cannot carry a "
                             f"halo of {n}")
        (prev,) = hop_wait(hop_start(comm, (x[:, -n:].contiguous(),)))
        first = torch.tensor(comm.rank == 0, device=prev.device)
        return prev.masked_fill(first, 0.0)

    return halo


def _make_ep_dispatch(comm: CPComm | None):
    """``ep_dispatch(x, topi, gates, params, *, kind, capacity_factor)``
    of one rank.  ``params`` is the layer's ``moe`` sub-tree; its expert
    leaves are this rank's E/N experts (the ZeRO-3 layout).  One rank:
    the local dispatch."""
    from repro_torch.models.moe import local_ep_dispatch

    def ep_dispatch(x, topi, gates, params, *, kind, capacity_factor):
        if comm is None:
            return local_ep_dispatch(x, topi, gates, params, kind=kind,
                                     capacity_factor=capacity_factor)
        E = params["router"].shape[-1]
        wi, wo = params["wi"], params["wo"]
        wg = params.get("wg", wi)       # unused by the gelu FFN
        if wi.shape[0] * comm.size != E:
            raise ValueError(f"{E} experts do not split over "
                             f"{comm.size} CP ranks")
        return _moe_island(x, topi, gates, wi, wg, wo, comm=comm,
                           kind=kind, capacity_factor=capacity_factor,
                           top_k=topi.shape[-1])

    return ep_dispatch


# ===================================================================== #
# context factory
# ===================================================================== #
def make_cp_context(plan_arrays: dict[str, Any], *,
                    strategy: str = "flashcp", impl: str = "plain",
                    head_dim: int, q_chunk: int = 512,
                    overlap: str = "chunked", block_q: int = 128,
                    block_k: int = 128, grid: str = "rect",
                    kv_comm_dtype: str = "native",
                    comm: CPComm | None = None,
                    world: CPComm | None = None) -> ExecContext:
    """The ExecContext of one rank's training step.

    ``plan_arrays`` are the batch's plan arrays in their global view: the
    plan-order ``doc``/``pos`` (B, C), the Eq.-5 ``send_idx`` (B, N, buf)
    whose N is the CP size (absent: one rank) and ``gath_doc``/
    ``gath_pos`` (B, N buf), and, for ``impl="flash"``, the per-rank visit
    tables of ``grid`` (``tab_*`` keys from
    :func:`repro_torch.planner.encode.emit_visit_tables`).  ``comm`` is
    this rank's CP group (required when N > 1); the context's
    ``doc``/``pos`` and its ``attn(q, k, v)`` are this rank's token
    slice.  ``world`` is the group of every rank that holds tokens of
    the batch (data x model), over which the MoE routing statistics are
    summed; None: this rank's CP group.  ``kv_comm_dtype`` is the K/V
    wire, ``"native"`` or ``"int8"``.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown CP strategy {strategy!r}; have "
                         f"{list(STRATEGIES)}")
    if impl not in ("flash", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'flash' or "
                         "'plain'")
    if grid not in ("rect", "flat"):
        raise ValueError(f"unknown kernel grid {grid!r}")
    if kv_comm_dtype not in ("native", "int8"):
        raise ValueError(f"unknown kv_comm_dtype {kv_comm_dtype!r}; use "
                         "'native' or 'int8'")
    int8 = kv_comm_dtype == "int8"
    overlap = resolve_overlap(strategy, impl, overlap)
    N = plan_arrays["send_idx"].shape[1] if "send_idx" in plan_arrays else 1
    if N > 1 and comm is None:
        raise ValueError(f"CP size {N} needs this rank's process group "
                         "(comm=CPComm(...))")
    if comm is not None and comm.size != N:
        raise ValueError(f"process group of {comm.size} ranks for a plan "
                         f"of {N}")
    me = 0 if comm is None else comm.rank
    if N == 1:
        comm = None

    doc, pos = plan_arrays["doc"], plan_arrays["pos"]
    t_loc = doc.shape[1] // N
    my = slice(me * t_loc, (me + 1) * t_loc)
    doc_l, pos_l = doc[:, my].contiguous(), pos[:, my].contiguous()

    def rank_tables(prefix):
        """This rank's slice of one table family, or None."""
        if impl != "flash":
            return None
        keys = table_keys(prefix, grid)
        if not all(k in plan_arrays for k in keys):
            raise ValueError(
                f"flash attention with overlap={overlap!r} needs per-rank "
                f"grid={grid!r} visit tables ({prefix}* plan arrays; see "
                "repro_torch.planner.encode.emit_visit_tables)")
        return tuple(plan_arrays[k][:, me].contiguous() for k in keys)

    scale = head_dim ** -0.5
    kw = dict(impl=impl, q_chunk=q_chunk, block_q=block_q, block_k=block_k,
              grid=grid)

    @functools.cache
    def tables():
        """This rank's tables: (local, hop) sets chunked, else the
        monolithic set; looked up at the first attention call, so a
        stack without attention (xLSTM) needs none."""
        if overlap == "chunked":
            return (rank_tables("tab_loc_"),
                    rank_tables("tab_hop_") if N > 1 else None)
        return rank_tables("tab_")

    if overlap == "chunked":
        part_attn = functools.partial(_partial_masked_attention, scale=scale,
                                      **kw)
    else:
        masked = functools.partial(_masked_attention, **kw)

    flashcp = strategy in _FLASHCP
    if flashcp:
        sidx = plan_arrays["send_idx"][:, me].contiguous() \
            if "send_idx" in plan_arrays else None
        gd, gp = plan_arrays.get("gath_doc"), plan_arrays.get("gath_pos")

    def attn(q, k, v):
        if overlap == "chunked":
            loc, hop = tables()

            def attend(kc, vc, dc, pc, tables):
                return part_attn(q, kc, vc, doc_l, pos_l, dc, pc,
                                 tables=tables)
            if flashcp:
                return _flashcp_island_chunked(
                    q, k, v, doc_l, pos_l, sidx, gd, gp, comm=comm,
                    attend=attend, loc_tables=loc, hop_tables=hop,
                    int8=int8)
            return _gather_island_chunked(q, k, v, doc_l, pos_l, comm=comm,
                                          attend=attend, loc_tables=loc,
                                          hop_tables=hop, int8=int8)
        mono = tables()
        if flashcp:
            return _flashcp_island(q, k, v, doc_l, pos_l, sidx, gd, gp,
                                   comm=comm, masked=masked, tables=mono,
                                   int8=int8)
        if strategy in ("ring", "ring_zigzag"):
            return _ring_island(q, k, v, doc_l, pos_l, comm=comm,
                                q_chunk=q_chunk, scale=scale)
        return _allgather_island(q, k, v, doc_l, pos_l, comm=comm,
                                 masked=masked, tables=mono, int8=int8)

    world = world or comm
    extras = {"ep_dispatch": _make_ep_dispatch(comm)}
    if world is not None:
        extras["token_sum"] = functools.partial(all_reduce_sum, comm=world)
    if comm is None:
        return ExecContext(doc=doc_l, pos=pos_l, attn=attn, extras=extras)
    extras["halo"] = _make_halo(comm)
    return ExecContext(
        doc=doc_l, pos=pos_l, attn=attn,
        ssm_scan=functools.partial(_ssm_island, comm=comm),
        selective_scan=functools.partial(_selective_scan_island, comm=comm),
        extras=extras)
