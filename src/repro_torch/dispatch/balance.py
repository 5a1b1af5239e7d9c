"""Cross-group token/workload balancing primitives (DESIGN.md §Dispatch).

Two host-side assignment problems, both solved with LPT-family greedy
algorithms over the planner's vectorized workload accounting
(:func:`repro_torch.planner.plan.shard_workload_array`):

* **pool → sequence bins** (:func:`pack_pool`): the global step's document
  pool is packed into ``n_bins`` sequence windows of ``capacity`` tokens.
  Worst-fit-decreasing (capacity-constrained LPT on *token counts*) keeps
  bin fills near-equal, so the batch stays only mildly ragged; a document
  that fits no bin is truncated into the emptiest one (the same remedy the
  per-rank packer applies at the window boundary).  Bin totals are rounded
  down to a ``quantum`` so every bin satisfies the planner's equal-token
  divisibility (Eq. 2 needs ``tokens % cp == 0``).
* **bins → DP×CP groups** (:func:`lpt_assign`): sequences are assigned to
  groups in decreasing *attention-workload* order, each to the least-loaded
  group with slots remaining (cardinality-constrained LPT) — every group
  receives exactly ``n_bins / n_groups`` sequences, so the batch axis
  shards evenly over the group (``"data"``) mesh axis.

Both primitives are *speed-aware* (DESIGN.md §Recovery): a per-group
``speeds`` vector turns :func:`lpt_assign` into capacity-proportional LPT
(the greedy minimizes the *completion time* ``(load + w) / speed``, so a
group at speed 0.5 receives roughly half the workload), and per-bin fill
``targets`` let :func:`pack_pool` shape bins to the speed distribution.
The straggler monitor's per-host EMA feeds these live — persistently slow
survivors get lighter bins instead of bounding every step.

Everything is pure numpy + Python; determinism follows from stable sorts
keyed on (weight, original index).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.planner.plan import shard_workload_array

__all__ = ["PackedPool", "sequence_workload", "pack_pool", "lpt_assign",
           "imbalance", "effective_imbalance"]


def sequence_workload(doc_lens) -> float:
    """Causal attention workload of one packed sequence: Σ_i d_i(d_i+1)/2.

    The whole-document case of the paper's shard workload W_i (prefix 0) —
    the quantity FlashCP balances *within* a CP group; the dispatcher
    balances its per-sequence sum *across* groups.
    """
    lens = np.asarray(doc_lens, dtype=np.int64)
    return float(shard_workload_array(np.zeros_like(lens), lens).sum())


def imbalance(loads) -> float:
    """max / mean of a load vector (1.0 = perfectly balanced)."""
    loads = np.asarray(loads, dtype=np.float64)
    if loads.size == 0:
        return 1.0
    avg = float(loads.mean())
    if avg <= 0.0:
        return 1.0
    return float(loads.max()) / avg


def effective_imbalance(loads, speeds=None) -> float:
    """Completion-time imbalance: max/mean of ``load / speed``.

    With ``speeds=None`` this is plain :func:`imbalance`.  Step time is
    the max over groups of the time each group needs, so a group at speed
    0.5 holding the mean load takes 2x the mean time — the quantity the
    speed-weighted dispatcher balances."""
    loads = np.asarray(loads, dtype=np.float64)
    if speeds is None:
        return imbalance(loads)
    speeds = np.asarray(speeds, dtype=np.float64)
    assert speeds.shape == loads.shape and (speeds > 0).all(), speeds
    return imbalance(loads / speeds)


@dataclasses.dataclass
class PackedPool:
    """Result of :func:`pack_pool`.

    ``bins[b]`` holds the (possibly truncated) document lengths of sequence
    ``b`` and ``bin_docs[b]`` the pool indices they came from, aligned
    element-for-element.  Every pool document appears in exactly one bin or
    in ``dropped_docs`` (truncated to nothing) — never both, never twice.
    """

    bins: list[np.ndarray]          # per-bin doc lengths (int64)
    bin_docs: list[np.ndarray]      # per-bin pool indices (int64)
    dropped_docs: np.ndarray        # pool indices truncated to zero length
    truncated_tokens: int           # pool tokens not placed in any bin

    @property
    def bin_tokens(self) -> np.ndarray:
        return np.asarray([int(b.sum()) for b in self.bins], np.int64)

    @property
    def bin_workloads(self) -> np.ndarray:
        return np.asarray([sequence_workload(b) for b in self.bins])


def pack_pool(doc_lens, n_bins: int, capacity: int, *,
              quantum: int = 1, targets=None) -> PackedPool:
    """Pack a document pool into ``n_bins`` sequence windows.

    Worst-fit-decreasing: documents are placed largest-first into the bin
    with the lowest current fill among bins with room — the
    capacity-constrained LPT that keeps per-bin token counts near-equal.
    A document that fits no bin is truncated into the bin with the most
    remaining room (``truncated_tokens`` accounts for the cut); afterwards
    each bin is trimmed so its total is a multiple of ``quantum``
    (trimming comes off the bin's largest documents, mirroring the
    per-rank packer's end-of-window truncation).

    ``targets``: optional per-bin fill targets (clipped to ``capacity``) —
    the speed-weighted dispatcher passes targets proportional to each
    prospective group's speed so slow groups receive lighter sequences
    (DESIGN.md §Recovery).  Fill-relative decisions ("lowest fill",
    "most room") are measured against each bin's own target, so a
    half-target bin at half fill is as "full" as a full-target bin at
    full fill.
    """
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    assert n_bins > 0 and capacity > 0 and quantum >= 1
    assert capacity % quantum == 0, (capacity, quantum)
    if targets is None:
        target = np.full(n_bins, capacity, np.int64)
    else:
        target = np.minimum(np.asarray(targets, np.int64), capacity)
        assert target.shape == (n_bins,), target.shape
        # a bin must hold at least one quantum or it becomes an empty row
        target = np.maximum(target, quantum)

    order = np.lexsort((np.arange(len(doc_lens)), -doc_lens))
    bins: list[list[int]] = [[] for _ in range(n_bins)]
    docs: list[list[int]] = [[] for _ in range(n_bins)]
    fill = np.zeros(n_bins, np.int64)
    dropped: list[int] = []
    truncated = 0

    for i in order:
        d = int(min(doc_lens[i], int(target.max())))
        truncated += int(doc_lens[i]) - d
        room = target - fill
        fits = np.nonzero(room >= d)[0]
        if len(fits):
            # least-filled bin (relative to target) with room;
            # ties -> lowest index (stable)
            rel = fill[fits] / target[fits]
            b = int(fits[np.argmin(rel)])
            take = d
        else:
            b = int(np.argmax(room))
            take = int(room[b])
            truncated += d - take
            if take == 0:
                dropped.append(int(i))
                continue
        bins[b].append(take)
        docs[b].append(int(i))
        fill[b] += take

    if quantum > 1:
        for b in range(n_bins):
            trim = int(fill[b] % quantum)
            while trim > 0 and bins[b]:
                j = int(np.argmax(bins[b]))
                cut = min(trim, bins[b][j])
                bins[b][j] -= cut
                trim -= cut
                truncated += cut
                fill[b] -= cut
                if bins[b][j] == 0:
                    dropped.append(docs[b].pop(j))
                    bins[b].pop(j)

    return PackedPool(
        bins=[np.asarray(b, np.int64) for b in bins],
        bin_docs=[np.asarray(d, np.int64) for d in docs],
        dropped_docs=np.asarray(sorted(dropped), np.int64),
        truncated_tokens=truncated,
    )


def lpt_assign(weights, n_groups: int, *, per_group: int | None = None,
               speeds=None) -> np.ndarray:
    """LPT assignment of weighted items to groups.

    Returns ``group_of_item`` (int64).  With ``per_group`` set, every group
    receives exactly that many items (cardinality-constrained LPT: each
    item goes to the least-loaded group with slots left); the classic LPT
    bound ``max_load <= mean_load + max(weight)`` still holds because the
    slot constraint only binds once loads are within one item of each
    other.

    ``speeds``: optional per-group positive speed factors (1.0 = full
    speed).  The greedy then minimizes projected *completion time*
    ``(load + w) / speed`` — capacity-proportional LPT on uniform
    machines (Q||Cmax): a group at speed 0.5 ends up with roughly half
    the load, so a persistent straggler stops bounding the step
    (DESIGN.md §Recovery).  ``speeds=None`` is exactly the classic path.
    """
    weights = np.asarray(weights, dtype=np.float64)
    n = len(weights)
    assert n_groups > 0
    if per_group is not None:
        assert per_group * n_groups == n, (n, n_groups, per_group)
    if speeds is not None:
        speeds = np.asarray(speeds, dtype=np.float64)
        assert speeds.shape == (n_groups,) and (speeds > 0).all(), speeds
    order = np.lexsort((np.arange(n), -weights))
    load = np.zeros(n_groups, np.float64)
    count = np.zeros(n_groups, np.int64)
    out = np.empty(n, np.int64)
    for i in order:
        open_g = np.nonzero(count < per_group)[0] if per_group is not None \
            else np.arange(n_groups)
        if speeds is None:
            g = int(open_g[np.argmin(load[open_g])])
        else:
            eta = (load[open_g] + weights[i]) / speeds[open_g]
            g = int(open_g[np.argmin(eta)])
        out[i] = g
        load[g] += weights[i]
        count[g] += 1
    return out
