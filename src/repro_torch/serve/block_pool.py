"""Global KV block pool: fixed-size blocks, free-list alloc, refcounts.

The serving engine's KV memory is one pool of ``num_blocks`` blocks of
``block_size`` token positions each (per layer — the device arrays live
in the engine's paged cache, see ``models.init_paged_cache``; this class
is the *host-side allocator* over their block index space).  Each
request owns a block table (list of physical block ids); blocks are
refcounted so a prefix block can back many tables at once
(serve/prefix.py) and stays allocated while the prefix cache itself
holds a reference.

Invariants:

* a block is either on the free list (refcount 0) or allocated
  (refcount >= 1) — never both;
* ``alloc`` is all-or-nothing: a request that cannot get every block it
  asked for gets none (admission backoff, no partial reservations);
* ``release`` decrements and returns blocks to the free list at zero —
  LIFO, so recently-freed blocks are reused first (warm HBM).

Host-side bookkeeping only; see ``ServeEngine`` for the device arrays.
"""

from __future__ import annotations

__all__ = ["BlockPool"]


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(f"bad pool geometry {num_blocks}x{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._ref = [0] * num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))   # pop() -> block 0
        self.peak_allocated = 0

    # ------------------------------------------------------------- #
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.allocated_count / self.num_blocks

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def is_shared(self, bid: int) -> bool:
        return self._ref[bid] > 1

    # ------------------------------------------------------------- #
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks off the free list (refcount 1 each), or
        ``None`` if fewer than ``n`` are free — all-or-nothing."""
        if n < 0:
            raise ValueError(n)
        if len(self._free) < n:
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            assert self._ref[b] == 0, (b, self._ref[b])
            self._ref[b] = 1
        self.peak_allocated = max(self.peak_allocated, self.allocated_count)
        return ids

    def retain(self, ids) -> None:
        """Add one reference to each allocated block in ``ids``."""
        for b in ids:
            if self._ref[b] <= 0:
                raise ValueError(f"retain of free block {b}")
            self._ref[b] += 1

    def release(self, ids) -> list[int]:
        """Drop one reference from each block; returns the blocks that
        reached refcount 0 and went back to the free list."""
        freed = []
        for b in ids:
            if self._ref[b] <= 0:
                raise ValueError(f"release of free block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "allocated": self.allocated_count,
                "free": self.free_count,
                "peak_allocated": self.peak_allocated,
                "occupancy": self.occupancy}
