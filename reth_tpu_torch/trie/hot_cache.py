"""Hot-state plane, host half: the cross-block trie-node cache.

Port of the JAX package's ``trie/hot_cache.py`` (host code, ported as it
is). Consecutive blocks, and sibling forks, touch heavily overlapping trie
paths, yet every block that starts from a blind trie re-fetches proofs for
paths the last few blocks already revealed. :class:`TrieNodeCache` keeps a
bounded map

    (owner, path, node hash) -> node RLP

where ``owner`` is ``b""`` for the account trie or the hashed address of a
storage trie, and ``path`` is the key-nibble position the node sits at (the
coordinates :class:`~reth_tpu_torch.trie.sparse.BlindedNodeError` reports).
It is never claimed: sibling forks and concurrent finishes all reveal from
it at once.

Correctness model, validation over invalidation:

- every lookup names the blinded node's expected hash (it is in the
  parent's ref) and an entry serves only when ``keccak(rlp)`` matches, so a
  stale or poisoned entry is a miss, never a wrong reveal;
  ``RETH_TPU_FAULT_HOTSTATE_POISON`` corrupts served entries to prove it;
- each committed block trims the version fan-out at the prefixes of its
  changed keys and re-puts the freshly committed spines
  (``absorb_block``); sibling forks' versions at the same paths coexist,
  since the hash is part of the key;
- ``clear`` is the wholesale invalidation of a deep reorg.

The device half, the digest arena that keeps last block's digests on the
card, is ``ops/fused_commit.py DigestArena``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from .. import tracing
from ..primitives.keccak import keccak256
from ..primitives.nibbles import unpack_nibbles

ACCOUNT_OWNER = b""  # owner key of the account trie


class HotStateFaultInjector:
    """Hot-state fault policies, as in the reference.

    ``poison_every``: every Nth cache lookup that would hit serves a
    bit-flipped RLP instead; node-hash validation must catch it (counted as
    ``poison_caught``, the lookup misses). ``evict_storm``: the digest arena
    evicts at every epoch and the node cache clears at every absorb, so
    every commit takes the full-upload epoch and every block re-primes the
    cache.

    Env form (:meth:`from_env`): ``RETH_TPU_FAULT_HOTSTATE_POISON`` /
    ``RETH_TPU_FAULT_HOTSTATE_EVICT_STORM``.
    """

    def __init__(self, poison_every: int = 0, evict_storm: bool = False):
        self.poison_every = poison_every
        self.evict_storm = evict_storm
        self.lookups = 0
        self.poisons = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "HotStateFaultInjector | None":
        env = os.environ if env is None else env
        poison = int(env.get("RETH_TPU_FAULT_HOTSTATE_POISON", "0") or 0)
        storm = env.get("RETH_TPU_FAULT_HOTSTATE_EVICT_STORM", "") not in ("", "0")
        if not (poison or storm):
            return None
        return cls(poison_every=poison, evict_storm=storm)

    def maybe_poison(self, rlp: bytes) -> bytes:
        """Corrupt every Nth served entry (before validation)."""
        if not self.poison_every:
            return rlp
        with self._lock:
            self.lookups += 1
            n = self.lookups
        if n % self.poison_every:
            return rlp
        with self._lock:
            self.poisons += 1
        tracing.fault_event("RETH_TPU_FAULT_HOTSTATE_POISON", target="trie::hot_cache", lookup=n)
        return bytes([rlp[0] ^ 0xFF]) + rlp[1:]


def hot_state_enabled(env=None) -> bool:
    """The ``RETH_TPU_HOT_STATE`` master switch (default off)."""
    env = os.environ if env is None else env
    return env.get("RETH_TPU_HOT_STATE", "") not in ("", "0")


class TrieNodeCache:
    """Bounded LRU of (owner, path, node hash) -> node RLP, validated by
    node hash at lookup.

    The node hash is part of the key, not just the validator: sibling forks
    alternate different nodes at the same (owner, path), and hash-keyed
    versions serve both sides of a fork at once, where an (owner, path)
    map would thrash. ``VERSIONS_PER_PATH`` bounds the per-path fan-out."""

    VERSIONS_PER_PATH = 4
    # a canonical write keeps this many newest versions at each dirtied
    # path prefix (the fork siblings' live spines), see invalidate_key
    INVALIDATE_KEEP = 2

    def __init__(self, max_entries: int = 200_000,
                 injector: HotStateFaultInjector | None = None):
        self.max_entries = max(16, int(max_entries))
        self.injector = injector if injector is not None else HotStateFaultInjector.from_env()
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[bytes, bytes, bytes], bytes] = OrderedDict()
        # (owner, path) -> insertion-ordered version hashes
        self._by_path: dict[tuple[bytes, bytes], OrderedDict[bytes, None]] = {}
        self._by_owner: dict[bytes, set[bytes]] = {}
        # counters (mirrored into the hotstate_* metrics by record_block)
        self.hits = 0
        self.misses = 0
        self.stale_drops = 0
        self.poison_caught = 0
        self.evictions = 0
        self.puts = 0
        self.clears = 0

    @classmethod
    def from_env(cls, env=None) -> "TrieNodeCache":
        env = os.environ if env is None else env
        return cls(max_entries=int(env.get("RETH_TPU_HOT_CACHE_ENTRIES", "200000") or 200_000))

    def __len__(self) -> int:
        return len(self._entries)

    # -- core -----------------------------------------------------------------

    def lookup(self, owner: bytes, path: bytes, expected_hash: bytes) -> bytes | None:
        """The version of (owner, path) whose hash is the blind's expected
        hash; anything else is a miss. The keccak check at serve time
        catches corruption and injected poisons."""
        key = (owner, path, expected_hash)
        with self._lock:
            rlp = self._entries.get(key)
            if rlp is not None:
                self._entries.move_to_end(key)
        if rlp is None:
            self.misses += 1
            return None
        served = rlp if self.injector is None else self.injector.maybe_poison(rlp)
        if keccak256(served) != expected_hash:
            # a corrupted or poisoned node never splices into a trie: drop
            # it (a poison leaves the intact entry) and pay the proof fetch
            if served is not rlp:
                self.poison_caught += 1
            else:
                self.stale_drops += 1
                self._drop_version(owner, path, expected_hash)
            self.misses += 1
            return None
        self.hits += 1
        return served

    def put(self, owner: bytes, path: bytes, rlp: bytes) -> None:
        h = keccak256(rlp)
        with self._lock:
            vs = self._by_path.setdefault((owner, path), OrderedDict())
            if not vs:
                self._by_owner.setdefault(owner, set()).add(path)
            vs[h] = None
            vs.move_to_end(h)
            self._entries[(owner, path, h)] = rlp
            self._entries.move_to_end((owner, path, h))
            self.puts += 1
            while len(vs) > self.VERSIONS_PER_PATH:
                old, _ = vs.popitem(last=False)
                self._entries.pop((owner, path, old), None)
                self.evictions += 1
            while len(self._entries) > self.max_entries:
                (o, p, oh), _ = self._entries.popitem(last=False)
                self._forget_version(o, p, oh)
                self.evictions += 1

    def _forget_version(self, owner: bytes, path: bytes, h: bytes) -> None:
        """Index clean-up after an entry left ``_entries`` (lock held)."""
        vs = self._by_path.get((owner, path))
        if vs is not None:
            vs.pop(h, None)
            if not vs:
                del self._by_path[(owner, path)]
                self._by_owner.get(owner, set()).discard(path)

    def _drop_version(self, owner: bytes, path: bytes, h: bytes) -> None:
        with self._lock:
            if self._entries.pop((owner, path, h), None) is not None:
                self._forget_version(owner, path, h)

    # -- invalidation ---------------------------------------------------------

    def invalidate_key(self, owner: bytes, key: bytes) -> None:
        """A changed leaf dirties every node on its path, every prefix of
        its key nibbles: trim each dirtied prefix down to its
        ``INVALIDATE_KEEP`` newest versions (the absorbing harvest re-puts
        the fresh spine right after). This is memory hygiene: a superseded
        version's hash is in no live parent ref, so it can never serve
        again, while sibling forks' live versions survive the trim."""
        nib = unpack_nibbles(key) if len(key) == 32 else key
        with self._lock:
            if not self._by_owner.get(owner):
                return
            for plen in range(len(nib) + 1):
                p = bytes(nib[:plen])
                vs = self._by_path.get((owner, p))
                if not vs:
                    continue
                while len(vs) > self.INVALIDATE_KEEP:
                    old, _ = vs.popitem(last=False)
                    self._entries.pop((owner, p, old), None)
                    self.evictions += 1

    def drop_owner(self, owner: bytes) -> None:
        """Wipe one storage trie's entries (SELFDESTRUCT, re-created)."""
        with self._lock:
            for p in self._by_owner.pop(owner, set()):
                for h in self._by_path.pop((owner, p), ()):
                    self._entries.pop((owner, p, h), None)

    def clear(self, reason: str = "") -> None:
        """Wholesale invalidation (a deep reorg, a storm)."""
        with self._lock:
            self._entries.clear()
            self._by_path.clear()
            self._by_owner.clear()
            self.clears += 1
        if reason:
            tracing.fault_event("hotstate_cache_clear", target="trie::hot_cache", reason=reason)

    # -- reveal from the cache ------------------------------------------------

    def reveal_through(self, trie, owner: bytes, hashed_key: bytes) -> bool:
        """Unblind ``trie`` along ``hashed_key`` from cached nodes alone:
        walk, BlindedNodeError(path), validated ``reveal_at``, retry. Each
        round reveals a strictly deeper blind, so it ends. True: the key is
        now readable without a proof fetch."""
        from .sparse import BlindedNodeError

        for _ in range(80):  # 64 nibbles and slack
            try:
                trie.get(hashed_key)
                return True
            except BlindedNodeError as e:
                path = bytes(e.path)
                h = trie.blind_hash_at(path)
                if h is None:
                    return False
                rlp = self.lookup(owner, path, h)
                if rlp is None or not trie.reveal_at(path, rlp):
                    return False
        return False

    # -- population -----------------------------------------------------------

    def harvest(self, trie, owner: bytes, keys) -> int:
        """Put the spine nodes along ``keys`` into the cache (nodes a
        commit recomputed, or nodes revealed with stamping: both have clean
        child refs on the walked paths)."""
        out: list[tuple[bytes, bytes]] = []
        seen: set[bytes] = set()
        for k in keys:
            trie.harvest_spine(k, out, seen)
        for path, rlp in out:
            self.put(owner, path, rlp)
        return len(out)

    def absorb_block(self, st, account_keys, storage_keys, wiped_owners=(),
                     touched_accounts=(), touched_storage=()) -> int:
        """One committed block's population pass: drop wiped owners, trim
        every changed key's path prefixes, then harvest the fresh spines of
        everything the block touched (changed keys: recomputed nodes;
        read-only touched keys: revealed nodes).

        ``st`` is the block's :class:`~reth_tpu_torch.trie.sparse
        .SparseStateTrie` after its root was computed and matched.
        ``storage_keys`` / ``touched_storage`` map owner (hashed address) to
        hashed slot keys."""
        if self.injector is not None and self.injector.evict_storm:
            self.clear("evict_storm")
        for owner in wiped_owners:
            self.drop_owner(owner)
        for k in account_keys:
            self.invalidate_key(ACCOUNT_OWNER, k)
        for owner, keys in storage_keys.items():
            for k in keys:
                self.invalidate_key(owner, k)
        n = self.harvest(st.account_trie, ACCOUNT_OWNER,
                         list(account_keys) + list(touched_accounts))
        merged: dict[bytes, set[bytes]] = {o: set(ks) for o, ks in storage_keys.items()}
        for o, ks in dict(touched_storage).items():
            merged.setdefault(o, set()).update(ks)
        for owner, keys in merged.items():
            t = st.storage_tries.get(owner)
            if t is not None:
                n += self.harvest(t, owner, keys)
        self.record_block()
        return n

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses,
                "stale_drops": self.stale_drops, "poison_caught": self.poison_caught,
                "evictions": self.evictions, "puts": self.puts, "clears": self.clears}

    def record_block(self) -> None:
        """Mirror the counters into the hotstate_* metrics."""
        from ..metrics import hotstate_metrics

        try:
            hotstate_metrics.record_cache(self.stats())
        except Exception:  # noqa: BLE001 — metrics never fail a commit
            pass
