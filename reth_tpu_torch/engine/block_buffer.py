"""Consensus-robustness primitives for the engine tree.

A copy of the JAX package's ``engine/block_buffer.py`` on the port's modules.

Reference analogue: `BlockBuffer`
(crates/engine/tree/src/tree/block_buffer.rs — bounded LRU of blocks
whose parent is unknown, with a parent→children index so the buffered
subtree replays the moment the missing parent arrives) and
`InvalidHeaderCache` (crates/engine/tree/src/tree/invalid_headers.rs —
a bounded LRU, because a hostile CL can flood `newPayload` with
distinct invalid blocks forever and an unbounded dict is a memory
leak).

On top of the two reference caches this module adds a
:class:`ReorgTracker`: reorg-depth accounting with storm detection.
The speculative machinery this repo keeps growing (preserved sparse
tries, optimistic execution, proof prefetch) is exactly what a
reorg-storming CL invalidates over and over — when forkchoice churns
pathologically the tracker dumps the flight recorder once and engages
a backoff window during which the engine serves blocks through the
non-speculative paths (serial execution + pipelined/incremental root),
which have no cross-block state for the attacker to thrash.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

from ..metrics import tree_metrics


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, "") or 0)
    except ValueError:
        v = 0
    return v if v > 0 else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def resolve_invalid_cache_size(size: int | None = None) -> int:
    """``--invalid-cache-size`` > ``RETH_TPU_INVALID_CACHE`` > 512."""
    if size is not None and size > 0:
        return size
    return _env_int("RETH_TPU_INVALID_CACHE", 512)


class BlockBuffer:
    """Bounded, timeout-evicted store of blocks awaiting their parent.

    ``insert`` refreshes LRU position; a full buffer evicts the
    least-recently-touched entry (an attacker streaming orphans pushes
    out its own garbage, not the honest chain the node is about to
    connect). Entries older than ``ttl`` seconds are lazily evicted on
    the next insert — a parent that never arrives must not pin memory.
    ``take_children_of`` removes and returns the direct children of a
    hash so the tree can replay them once that parent validates.
    """

    def __init__(self, limit: int | None = None, ttl: float | None = None,
                 clock=time.monotonic):
        self.limit = (limit if limit is not None and limit > 0
                      else _env_int("RETH_TPU_BLOCK_BUFFER", 256))
        self.ttl = (ttl if ttl is not None
                    else _env_float("RETH_TPU_BLOCK_BUFFER_TTL", 60.0))
        self._clock = clock
        self._blocks: OrderedDict[bytes, tuple[object, float]] = OrderedDict()
        self._children: dict[bytes, set[bytes]] = {}
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, block_hash: bytes) -> bool:
        return block_hash in self._blocks

    def insert(self, block) -> None:
        self.evict_expired()
        h = block.hash
        if h in self._blocks:
            self._blocks.move_to_end(h)
            return
        while len(self._blocks) >= self.limit:
            old_h, (old_b, _) = self._blocks.popitem(last=False)
            self._unlink(old_h, old_b)
            self.evicted += 1
            tree_metrics.orphan_evicted()
        self._blocks[h] = (block, self._clock())
        self._children.setdefault(block.header.parent_hash, set()).add(h)
        tree_metrics.set_orphans(len(self._blocks))

    def get(self, block_hash: bytes):
        entry = self._blocks.get(block_hash)
        return entry[0] if entry is not None else None

    def pop(self, block_hash: bytes, default=None):
        entry = self._blocks.pop(block_hash, None)
        if entry is None:
            return default
        block, _ = entry
        self._unlink(block_hash, block)
        tree_metrics.set_orphans(len(self._blocks))
        return block

    def take_children_of(self, parent_hash: bytes) -> list:
        """Remove and return the buffered DIRECT children of
        ``parent_hash`` (the caller recurses through replay — a child
        that turns out invalid must invalidate, not replay, its own
        descendants)."""
        out = []
        for h in sorted(self._children.get(parent_hash, ())):
            blk = self.pop(h)
            if blk is not None:
                out.append(blk)
        return out

    def evict_expired(self) -> None:
        if not self.ttl:
            return
        now = self._clock()
        stale = [h for h, (_, ts) in self._blocks.items()
                 if now - ts > self.ttl]
        for h in stale:
            block, _ = self._blocks.pop(h)
            self._unlink(h, block)
            self.evicted += 1
            tree_metrics.orphan_evicted()
        if stale:
            tree_metrics.set_orphans(len(self._blocks))

    def _unlink(self, block_hash: bytes, block) -> None:
        sibs = self._children.get(block.header.parent_hash)
        if sibs is not None:
            sibs.discard(block_hash)
            if not sibs:
                del self._children[block.header.parent_hash]


class InvalidHeaderCache:
    """Bounded LRU of invalid block hash → rejection reason.

    Drop-in for the engine tree's old unbounded dict (``h in cache``,
    ``cache[h]``, ``cache[h] = reason``). Lookups refresh LRU position
    so the invalid blocks a CL keeps re-sending stay cached while
    one-shot flood entries age out. Eviction is safe: a re-sent evicted
    block simply re-validates (or buffers as unknown-parent) — bounded
    memory traded for re-checking, the reference's exact trade.
    """

    def __init__(self, capacity: int | None = None):
        self.capacity = resolve_invalid_cache_size(capacity)
        self._entries: OrderedDict[bytes, str] = OrderedDict()
        self.evicted = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, block_hash: bytes) -> bool:
        if block_hash in self._entries:
            self._entries.move_to_end(block_hash)
            self.hits += 1
            return True
        return False

    def __getitem__(self, block_hash: bytes) -> str:
        reason = self._entries[block_hash]
        self._entries.move_to_end(block_hash)
        return reason

    def get(self, block_hash: bytes, default=None):
        if block_hash in self._entries:
            return self[block_hash]
        return default

    def __setitem__(self, block_hash: bytes, reason: str) -> None:
        self.insert(block_hash, reason)

    def insert(self, block_hash: bytes, reason: str) -> None:
        self._entries[block_hash] = reason
        self._entries.move_to_end(block_hash)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evicted += 1
            tree_metrics.invalid_evicted()
        tree_metrics.set_invalid(len(self._entries), self.capacity)


class ReorgTracker:
    """Reorg-depth accounting with storm detection and backoff.

    ``record(depth)`` returns True when the records within ``window_s``
    cross either trip wire (``storm_count`` reorgs, or ``storm_depth``
    total abandoned blocks) and a storm newly engages. While a storm is
    live every further reorg extends the backoff (capped exponential);
    :meth:`in_backoff` is the engine's cue to stop feeding the
    speculative paths until forkchoice calms down.
    """

    def __init__(self, window_s: float | None = None,
                 storm_count: int | None = None,
                 storm_depth: int | None = None,
                 backoff_s: float | None = None,
                 clock=time.monotonic):
        self.window_s = (window_s if window_s is not None
                         else _env_float("RETH_TPU_REORG_STORM_WINDOW", 30.0))
        self.storm_count = (storm_count if storm_count is not None
                            else _env_int("RETH_TPU_REORG_STORM_COUNT", 6))
        self.storm_depth = (storm_depth if storm_depth is not None
                            else _env_int("RETH_TPU_REORG_STORM_DEPTH", 16))
        self.base_backoff_s = (backoff_s if backoff_s is not None
                               else _env_float("RETH_TPU_REORG_BACKOFF", 10.0))
        self._clock = clock
        self._events: list[tuple[float, int]] = []  # (ts, depth)
        self._backoff_until = 0.0
        self._backoff_s = self.base_backoff_s
        self.reorgs = 0
        self.max_depth = 0
        self.storms = 0

    def record(self, depth: int) -> bool:
        """Account one reorg of ``depth`` abandoned blocks; True when a
        storm newly engages (caller dumps the flight recorder once)."""
        if depth <= 0:
            return False
        now = self._clock()
        self.reorgs += 1
        self.max_depth = max(self.max_depth, depth)
        self._events.append((now, depth))
        cutoff = now - self.window_s
        self._events = [(t, d) for t, d in self._events if t >= cutoff]
        stormy = (len(self._events) >= self.storm_count
                  or sum(d for _, d in self._events) >= self.storm_depth)
        if not stormy:
            return False
        newly = now >= self._backoff_until
        if newly:
            self.storms += 1
            self._backoff_s = self.base_backoff_s
        else:
            self._backoff_s = min(self._backoff_s * 2, 120.0)
        self._backoff_until = now + self._backoff_s
        return newly

    def in_backoff(self) -> bool:
        active = self._clock() < self._backoff_until
        tree_metrics.set_backoff(active)
        return active
