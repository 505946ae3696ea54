"""Radix-tree prefix cache: block-granular KV sharing across requests.

SWIS deduplicates *weights* (shared shift values across groups); at serving
scale the same economics apply to *activations*. The KV arena is carved into
fixed-size blocks of ``block_size`` token positions. A completed request
commits the full blocks of its token sequence into a radix trie keyed on the
block's token contents; a later request whose prompt shares a block-aligned
prefix re-references those physical blocks (refcount++) instead of
recomputing them, and prefills only the uncached suffix.

Two pieces, both pure host-side bookkeeping (the K/V payload lives in the
:class:`~repro_torch.serve.kv_cache.SlotKVCache` device arena):

* :class:`BlockPool` — free-list + per-block slot refcounts over the arena.
  Block 0 is reserved as the garbage sink for free-slot dummy decode writes
  and is never allocated.
* :class:`RadixPrefixCache` — trie of committed blocks. One node per block;
  an edge is the ``block_size``-token chunk it covers. Unreferenced leaf
  nodes are evictable, LRU-first, so the trie doubles as the eviction queue.

Invariants (pinned by ``tests/test_prefix_cache.py`` (reference package)):
  * a matched prefix is always a chain of committed blocks from the root;
  * refcounts never go negative (``decref`` raises);
  * eviction never drops a block that is referenced or has children.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class BlockPool:
    """Free-list + slot refcounts over ``n_blocks`` physical KV blocks.

    ``refcount`` counts *slot* references only; trie membership is tracked
    by the :class:`RadixPrefixCache` that owns this pool. A block at
    refcount 0 that is not committed to the trie belongs on the free list.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the trash block), "
                             f"got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.refcount = np.zeros(n_blocks, np.int64)
        # Block 0 is the reserved trash block: free-slot dummy decode
        # writes land there and block-table entry 0 means "invalid" to
        # the paged decode kernel. Pin its refcount so free([0]) raises
        # and it can never re-enter circulation as live storage.
        self.refcount[0] = 1
        # LIFO free list; block 0 reserved as the trash block
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))

    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free blocks, or None (caller evicts and retries)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, ids: Sequence[int]) -> None:
        for b in ids:
            if self.refcount[b] != 0:
                raise RuntimeError(f"freeing referenced block {b} "
                                   f"(rc={self.refcount[b]})")
            self._free.append(int(b))

    def incref(self, ids: Sequence[int]) -> None:
        for b in ids:
            self.refcount[b] += 1

    def occupancy(self) -> Dict[str, float]:
        """Arena occupancy gauges for ``engine.metrics()['block_pool']``
        (the reserved trash block 0 is excluded from the usable count)."""
        usable = self.n_blocks - 1
        free = len(self._free)
        return {"n_blocks": self.n_blocks,
                "usable_blocks": usable,
                "free_blocks": free,
                "used_blocks": usable - free,
                "referenced_blocks": int(
                    np.count_nonzero(self.refcount[1:])),
                "occupancy": (usable - free) / max(usable, 1)}

    def decref(self, ids: Sequence[int]) -> None:
        for b in ids:
            self.refcount[b] -= 1
            if self.refcount[b] < 0:
                raise RuntimeError(f"refcount of block {b} went negative")


class _Node:
    __slots__ = ("chunk", "block", "parent", "children", "tick")

    def __init__(self, chunk: bytes, block: int, parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.tick = 0


class RadixPrefixCache:
    """Trie of committed KV blocks keyed on token-block contents."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._root = _Node(b"", -1, None)
        self._node_of_block: Dict[int, _Node] = {}
        self._tick = 0
        # counters surfaced via stats(); lookups/hits/hit_blocks are
        # incremented by the caller on *successful* admission only, so a
        # pool-starved request retried across many steps counts once
        self.lookups = 0
        self.hits = 0
        self.hit_blocks = 0
        self.commits = 0
        self.evictions = 0

    # -- key encoding ----------------------------------------------------

    def _chunks(self, tokens: np.ndarray) -> List[bytes]:
        bs = self.pool.block_size
        toks = np.asarray(tokens, np.int32)
        return [toks[i:i + bs].tobytes()
                for i in range(0, (len(toks) // bs) * bs, bs)]

    # -- lookup ----------------------------------------------------------

    def match(self, tokens: np.ndarray,
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest committed block-chain prefix of ``tokens``. Returns the
        physical block ids root-outward and refreshes their LRU recency.
        Does not count stats — call :meth:`count_lookup` once the lookup
        actually leads to an admission."""
        return self._walk(tokens, max_blocks, touch=True)

    def count_lookup(self, matched: List[int]) -> None:
        self.lookups += 1
        if matched:
            self.hits += 1
            self.hit_blocks += len(matched)

    def peek_blocks(self, tokens: np.ndarray,
                    max_blocks: Optional[int] = None) -> int:
        """Match length in blocks without touching recency or counters
        (cache-aware admission scoring must not perturb the LRU)."""
        return len(self._walk(tokens, max_blocks, touch=False))

    def _walk(self, tokens, max_blocks, touch: bool) -> List[int]:
        node = self._root
        ids: List[int] = []
        chunks = self._chunks(tokens)
        if max_blocks is not None:
            chunks = chunks[:max_blocks]
        if touch:
            self._tick += 1
        for chunk in chunks:
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            if touch:
                nxt.tick = self._tick
            ids.append(nxt.block)
            node = nxt
        return ids

    # -- commit ----------------------------------------------------------

    def commit(self, tokens: np.ndarray, block_ids: Sequence[int]) -> None:
        """Commit ``block_ids[i]`` as the cache entry for the i-th full
        token block of ``tokens``. Chunks already present keep their
        existing block (the caller's duplicate stays slot-owned and is
        freed on release); absent chunks adopt the caller's block."""
        chunks = self._chunks(tokens)
        assert len(block_ids) <= len(chunks), (len(block_ids), len(chunks))
        self._tick += 1
        node = self._root
        for chunk, blk in zip(chunks, block_ids):
            nxt = node.children.get(chunk)
            if nxt is None:
                blk = int(blk)
                if blk in self._node_of_block:
                    # physical block already backs a different chain; do
                    # not alias — stop committing this chain here
                    break
                nxt = _Node(chunk, blk, node)
                node.children[chunk] = nxt
                self._node_of_block[blk] = nxt
                self.commits += 1
            nxt.tick = self._tick
            node = nxt

    # -- release / eviction ---------------------------------------------

    def release(self, block_ids: Sequence[int]) -> None:
        """Drop one slot reference per block; blocks that are neither
        referenced nor committed go back to the free list."""
        self.pool.decref(block_ids)
        self.pool.free([b for b in block_ids
                        if self.pool.refcount[b] == 0
                        and b not in self._node_of_block])

    def is_committed(self, block: int) -> bool:
        return block in self._node_of_block

    def n_cached(self) -> int:
        return len(self._node_of_block)

    def evict(self, n: int) -> int:
        """Evict up to ``n`` unreferenced leaf blocks, LRU-first, back to
        the free list. Returns the number evicted. Interior nodes become
        eligible as their children go; referenced blocks never do."""
        evicted = 0
        while evicted < n:
            victim = None
            for node in self._node_of_block.values():
                if node.children or self.pool.refcount[node.block] != 0:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.chunk]
            del self._node_of_block[victim.block]
            self.pool.free([victim.block])
            self.evictions += 1
            evicted += 1
        return evicted

    # -- stats -----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / max(self.lookups, 1),
            "hit_blocks": self.hit_blocks,
            "commits": self.commits,
            "evictions": self.evictions,
            "cached_blocks": self.n_cached(),
            "free_blocks": self.pool.n_free(),
        }
