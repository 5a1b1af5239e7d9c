"""Prefix cache: a hash-chain trie over *full* prompt token blocks.

Identical prompt prefixes (system prompts, few-shot preambles) are
prefilled once: after a request's prefill completes, each full
``block_size`` block of its *prompt* is registered under the key
``(parent_block_id, block_tokens)`` — the parent id uniquely identifies
the whole prefix chain, so lookup is exact (no hash collisions to
reason about) and O(blocks).  A later request walks the chain from the
root and adopts every matched block into its own table (pool refcount
+1 per reader), skipping that prefix's prefill compute entirely.

Only full blocks are cached — a partially-filled tail is private to its
request (sharing it would force copy-on-write on every first decode
append).  Generated tokens are never cached.  When a request's prompt
is *entirely* made of matched full blocks, the engine still recomputes
the final prompt token (its logits seed sampling) — the write lands in
the last matched block, which is shared, so the engine copy-on-writes
it first (the ``cow_copies`` stat counts exactly these).

Cached blocks carry one reference from the cache itself, so they stay
pool-resident after their last reader retires.  ``evict`` walks blocks
in LRU order (touched on match) and frees *leaf* nodes with no readers
(refcount 1 — the cache's own) — parents are only evictable once their
children are gone, keeping every remaining chain matchable.
"""

from __future__ import annotations

__all__ = ["PrefixCache"]

_ROOT = -1


class PrefixCache:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_key: dict[tuple, int] = {}     # (parent_bid, tokens) -> bid
        self._key_of: dict[int, tuple] = {}     # bid -> its key
        self._children: dict[int, int] = {}     # bid -> live child count
        self._lru: list[int] = []               # bids, oldest first
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._by_key)

    # ------------------------------------------------------------- #
    def _touch(self, bid: int) -> None:
        try:
            self._lru.remove(bid)
        except ValueError:
            pass
        self._lru.append(bid)

    def match(self, tokens) -> list[int]:
        """Longest chain of cached full blocks prefixing ``tokens``.
        Returns their block ids (possibly empty); matched blocks are
        LRU-touched.  The caller must ``pool.retain`` them."""
        bs = self.block_size
        ids: list[int] = []
        parent = _ROOT
        for k in range(len(tokens) // bs):
            key = (parent, tuple(int(t) for t in tokens[k * bs:(k + 1) * bs]))
            bid = self._by_key.get(key)
            if bid is None:
                break
            ids.append(bid)
            self._touch(bid)
            parent = bid
        self.hits += len(ids) * bs
        self.misses += len(tokens) - len(ids) * bs
        return ids

    def insert(self, tokens, block_ids, pool) -> int:
        """Register the full blocks of ``tokens`` (backed by
        ``block_ids``, the owning request's table prefix).  Blocks whose
        chain key already exists are skipped (a concurrent identical
        prompt won the race; its copy stays canonical).  New blocks get
        a cache reference (``pool.retain``).  Returns #blocks added."""
        bs = self.block_size
        parent = _ROOT
        added = 0
        for k in range(len(tokens) // bs):
            key = (parent, tuple(int(t) for t in tokens[k * bs:(k + 1) * bs]))
            bid = self._by_key.get(key)
            if bid is None:
                bid = int(block_ids[k])
                self._by_key[key] = bid
                self._key_of[bid] = key
                self._children[bid] = 0
                if parent != _ROOT:
                    self._children[parent] += 1
                pool.retain([bid])
                self._lru.append(bid)
                added += 1
            parent = bid
        return added

    # ------------------------------------------------------------- #
    def evict(self, n_blocks: int, pool) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU leaf
        nodes nobody is reading (refcount 1 = only the cache's own
        reference).  Returns the number actually freed."""
        freed = 0
        progress = True
        while freed < n_blocks and progress:
            progress = False
            for bid in list(self._lru):
                if self._children.get(bid, 0) == 0 \
                        and pool.refcount(bid) == 1:
                    self._drop(bid, pool)
                    freed += 1
                    progress = True
                    if freed >= n_blocks:
                        break
        return freed

    def _drop(self, bid: int, pool) -> None:
        key = self._key_of.pop(bid)
        del self._by_key[key]
        del self._children[bid]
        self._lru.remove(bid)
        parent = key[0]
        if parent != _ROOT:
            self._children[parent] -= 1
        pool.release([bid])

    # ------------------------------------------------------------- #
    def hit_rate(self) -> float:
        seen = self.hits + self.misses
        return self.hits / seen if seen else 0.0

    def stats(self) -> dict:
        return {"nodes": len(self), "hit_tokens": self.hits,
                "miss_tokens": self.misses, "hit_rate": self.hit_rate()}
