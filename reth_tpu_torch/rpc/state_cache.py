"""LRU caches for the eth API's hot block/receipt reads.

A copy of the JAX package's ``rpc/state_cache.py``.

Reference analogue: `EthStateCache` (crates/rpc/rpc-eth-types) — repeated
RPC reads of recent blocks (trackers poll the same few blocks with
getBlockByNumber/getBlockReceipts) are served from memory instead of
re-walking the database. Entries are keyed by block HASH, so content is
immutable and reorgs need no invalidation: a reorged-out hash simply
stops being requested and ages out of the LRU.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..metrics import REGISTRY


class EthStateCache:
    def __init__(self, max_blocks: int = 256):
        self.max_blocks = max_blocks
        self._blocks: OrderedDict[bytes, tuple] = OrderedDict()
        self._receipts: OrderedDict[bytes, list] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = REGISTRY.counter("rpc_state_cache_hits_total")
        self._misses = REGISTRY.counter("rpc_state_cache_misses_total")

    def _get(self, store: OrderedDict, key: bytes):
        with self._lock:
            if key in store:
                store.move_to_end(key)
                self._hits.increment()
                return store[key]
        self._misses.increment()
        return None

    def _put(self, store: OrderedDict, key: bytes, value) -> None:
        with self._lock:
            store[key] = value
            store.move_to_end(key)
            while len(store) > self.max_blocks:
                store.popitem(last=False)

    def block_with_senders(self, p, number: int):
        """(block, senders) at a canonical height, or None."""
        h = p.canonical_hash(number)
        if h is None:
            return None
        cached = self._get(self._blocks, h)
        if cached is not None:
            return cached
        block = p.block_by_number(number)
        if block is None:
            return None
        idx = p.block_body_indices(number)
        senders = []
        if idx is not None:
            senders = [p.sender(t)
                       for t in range(idx.first_tx_num, idx.next_tx_num)]
        value = (block, senders)
        self._put(self._blocks, h, value)
        return value

    def receipts(self, p, number: int):
        """The block's receipts list, or None when unavailable."""
        h = p.canonical_hash(number)
        if h is None:
            return None
        cached = self._get(self._receipts, h)
        if cached is not None:
            return cached
        idx = p.block_body_indices(number)
        if idx is None:
            return None
        out = []
        for t in range(idx.first_tx_num, idx.next_tx_num):
            r = p.receipt(t)
            if r is None:
                return None
            out.append(r)
        self._put(self._receipts, h, out)
        return out
