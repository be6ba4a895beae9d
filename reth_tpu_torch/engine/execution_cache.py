"""Cross-block execution cache: warm account/storage/bytecode reads.

A copy of the JAX package's ``engine/execution_cache.py`` on the port's modules.

Reference analogue: crates/engine/execution-cache (CachedStateProvider/
SavedCache) — consecutive payloads read mostly the same hot state, so
the tree keeps one cache across blocks, serves reads through it, and
INVALIDATES exactly the keys the applied block changed (a stale entry
would be a consensus bug; wholesale clearing would lose the warmth).
"""

from __future__ import annotations

from collections import OrderedDict

_MISS = object()


class _Lru:
    """Thread-safe LRU: the prewarm workers (engine/prewarm.py) populate
    these caches from several threads while nothing else runs, and the
    sequential executor reads them after — a mutex keeps the OrderedDict
    reorders from interleaving."""

    __slots__ = ("cap", "data", "hits", "misses", "_mu")

    def __init__(self, cap: int):
        import threading

        self.cap = cap
        self.data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._mu = threading.Lock()

    def get(self, key):
        with self._mu:
            v = self.data.get(key, _MISS)
            if v is _MISS:
                self.misses += 1
                return _MISS
            self.data.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        with self._mu:
            self.data[key] = value
            self.data.move_to_end(key)
            while len(self.data) > self.cap:
                self.data.popitem(last=False)

    def drop(self, key) -> None:
        with self._mu:
            self.data.pop(key, None)


class ExecutionCache:
    """Shared caches, safe across blocks via precise invalidation."""

    def __init__(self, accounts: int = 50_000, storage: int = 200_000,
                 code: int = 2_000):
        self.accounts = _Lru(accounts)
        self.storage = _Lru(storage)
        self.code = _Lru(code)
        # address -> cached slot keys, so storage wipes invalidate in
        # O(address's slots) instead of scanning the whole LRU
        self._slots_of: dict[bytes, set] = {}

    def on_block_applied(self, changes) -> None:
        """Invalidate everything the block touched (BlockChanges)."""
        for addr in changes.accounts:
            self.accounts.drop(addr)
        for addr, slots in changes.storage.items():
            index = self._slots_of.get(addr)
            for slot in slots:
                self.storage.drop((addr, slot))
                if index is not None:
                    index.discard(slot)
        for addr in changes.wiped_storage:
            for slot in self._slots_of.pop(addr, ()):
                self.storage.drop((addr, slot))
        # new code is append-only (keyed by hash): nothing to invalidate

    def stats(self) -> dict:
        return {
            "account_hits": self.accounts.hits, "account_misses": self.accounts.misses,
            "storage_hits": self.storage.hits, "storage_misses": self.storage.misses,
        }


class CachedStateSource:
    """StateSource wrapper serving reads through the shared cache."""

    def __init__(self, inner, cache: ExecutionCache):
        self.inner = inner
        self.cache = cache

    def account(self, address: bytes):
        v = self.cache.accounts.get(address)
        if v is _MISS:
            v = self.inner.account(address)
            self.cache.accounts.put(address, v)
        return v

    def storage(self, address: bytes, slot: bytes) -> int:
        v = self.cache.storage.get((address, slot))
        if v is _MISS:
            v = self.inner.storage(address, slot)
            self.cache.storage.put((address, slot), v)
            self.cache._slots_of.setdefault(address, set()).add(slot)
        return v

    def bytecode(self, code_hash: bytes) -> bytes:
        v = self.cache.code.get(code_hash)
        if v is _MISS:
            v = self.inner.bytecode(code_hash)
            self.cache.code.put(code_hash, v)
        return v
