"""Overlay transactions: in-memory write layers over a base snapshot.

A copy of the JAX package's ``storage/overlay.py`` over the port's
``storage/kv.py``. Three additions, with the reference's results:

- ``OverlayTx.seek_dup``, the subkey lookup the port's provider and proof
  calculator make through ``Tx.seek_dup``: the first duplicate of a key at
  or above a subkey in the merged view, the newest layer that holds the key
  first, so a layer's deleted key or removed duplicate (a slot written to
  zero) hides the base's;
- ``_sorted_keys`` merges the base transaction's sorted key index with the
  layers' new keys, each put in by bisection, instead of sorting the set of
  their union, so a cursor made after a write, or on a fresh view, costs
  one pass over the table; a layer key is new when that index lacks it
  (bisection), where the reference reads the key's duplicates from the
  base;
- over a store other than ``MemDb`` (the paged and native engines), a
  key's base duplicates are read from the base transaction once and kept
  for the overlay's life (``_base_get``): the base is a read transaction no
  write of the overlay reaches, and a DUPSORT read there walks every
  duplicate of the key (an owner's whole storage or storage trie) through
  the engine's cursor, once per slot read or trie-node delete without the
  cache.

Reference analogue: `MemoryOverlayStateProvider` + in-memory trie overlay
cursors (crates/chain-state/src/in_memory.rs,
crates/trie/trie/src/trie_cursor/in_memory.rs) — but generalised: an
``OverlayTx`` speaks the same Tx/Cursor interface as a real transaction
while routing writes to a per-block layer dict and merging reads across
[layer_n, ..., layer_1, base]. Every subsystem (executor reads, hashing
writes, the incremental-root committer's cursor scans, receipts) works
unchanged on pending blocks, and persisting a block = applying its layer
to a real write transaction.
"""

from __future__ import annotations

import bisect

from .kv import Cursor, Tx

_TOMBSTONE = object()

Layer = dict[str, dict[bytes, object]]  # table -> key -> value | _TOMBSTONE


def _holds(keys: list[bytes], key: bytes) -> bool:
    """Whether the sorted ``keys`` hold ``key``."""
    i = bisect.bisect_left(keys, key)
    return i < len(keys) and keys[i] == key


class _MergedTable:
    """Read view of one table across write layer + parents + base."""

    def __init__(self, overlay: "OverlayTx", table: str):
        self._overlay = overlay
        self._table_name = table

    def get(self, key: bytes, default=None):
        for layer in self._overlay._layers_newest_first():
            t = layer.get(self._table_name)
            if t is not None and key in t:
                v = t[key]
                return default if v is _TOMBSTONE else v
        v = self._overlay._base_get(self._table_name, key)
        return default if v is None else v

    def __contains__(self, key: bytes) -> bool:
        return self.get(key) is not None


class OverlayTx:
    """Tx-compatible view: reads merge layers over base; writes hit ``layer``.

    ``parent_layers``: ancestor block layers, oldest→newest. ``layer`` is
    this block's own (mutable) layer. The base ``Tx`` must stay open for
    the overlay's lifetime.
    """

    def __init__(self, base: Tx, parent_layers: list[Layer] | None = None,
                 layer: Layer | None = None):
        self.base = base
        self.parent_layers = list(parent_layers or [])
        self.layer: Layer = layer if layer is not None else {}
        self._write = True
        self._key_cache: dict[str, list[bytes]] = {}
        # (table, key) -> the base's duplicates, off MemDb (see _base_get)
        self._base_dups: dict[tuple[str, bytes], tuple] = {}

    # -- layer plumbing -------------------------------------------------------

    def _layers_newest_first(self):
        yield self.layer
        for l in reversed(self.parent_layers):
            yield l

    def _base_get(self, table: str, key: bytes):
        """Backend-agnostic base read: value bytes, dup list, or None.

        Fast path for MemDb (direct table dict); generic path goes through
        the Tx duck interface (works over the native C++ engine too).
        """
        if hasattr(self.base, "_table"):  # MemDb fast path (snapshot-aware)
            return self.base._table(table).get(key)
        dups = self._base_dups.get((table, key))
        if dups is None:
            dups = self._base_dups[table, key] = tuple(self.base.get_dups(table, key))
        if not dups:
            return None
        # always a list: keeps dup-delete semantics identical across
        # backends (a single-dup entry must NOT collapse to plain bytes)
        return list(dups)

    def _table(self, table: str) -> _MergedTable:
        return _MergedTable(self, table)

    def _sorted_keys(self, table: str) -> list[bytes]:
        cached = self._key_cache.get(table)
        if cached is not None:
            return cached
        dead: set[bytes] = set()
        live: set[bytes] = set()
        for layer in self._layers_newest_first():
            t = layer.get(table)
            if not t:
                continue
            for k, v in t.items():
                if k in dead or k in live:
                    continue
                (dead if v is _TOMBSTONE else live).add(k)
        base_keys = self.base._sorted_keys(table)
        # a live key is new when the base's sorted index lacks it: found by
        # bisection, with no read of the key's duplicates
        extra = sorted(k for k in live if not _holds(base_keys, k))
        if dead:
            base_keys = [k for k in base_keys if k not in dead]
        # the few layer keys go in by bisection: one pass over the base's
        # run, no comparison sort of the whole table
        merged, lo = [], 0
        for k in extra:
            i = bisect.bisect_right(base_keys, k, lo)
            merged.extend(base_keys[lo:i])
            merged.append(k)
            lo = i
        merged.extend(base_keys[lo:])
        self._key_cache[table] = merged
        return merged

    # -- reads ----------------------------------------------------------------

    def get(self, table: str, key: bytes):
        v = self._table(table).get(key)
        if isinstance(v, list):
            return v[0] if v else None
        return v

    def get_dups(self, table: str, key: bytes) -> list[bytes]:
        v = self._table(table).get(key)
        if v is None:
            return []
        return list(v) if isinstance(v, list) else [v]

    def seek_dup(self, table: str, key: bytes, subkey: bytes) -> bytes | None:
        """The first duplicate of ``key`` whose value >= ``subkey`` in the
        merged view: the value ``cursor(table).seek_by_key_subkey(key,
        subkey)`` lands on, found without building the merged key index."""
        v = self._table(table).get(key)
        if v is None:
            return None
        dups = v if isinstance(v, list) else [v]
        j = bisect.bisect_left(dups, subkey)
        return dups[j] if j < len(dups) else None

    def cursor(self, table: str) -> Cursor:
        return Cursor(self, table)

    def entry_count(self, table: str) -> int:
        n = 0
        for k in self._sorted_keys(table):
            v = self._table(table).get(k)
            n += len(v) if isinstance(v, list) else 1
        return n

    # -- writes (into the own layer, copy-on-write per key) -------------------

    def _own(self, table: str, key: bytes):
        t = self.layer.setdefault(table, {})
        if key not in t:
            # read through parents+base, NOT the own layer (it lacks the key)
            prev = None
            for layer in self.parent_layers[::-1]:
                lt = layer.get(table)
                if lt is not None and key in lt:
                    prev = lt[key]
                    break
            else:
                prev = self._base_get(table, key)
            if prev is _TOMBSTONE:
                prev = None
            t[key] = list(prev) if isinstance(prev, list) else prev
        if t[key] is _TOMBSTONE:
            t[key] = None
        return t

    def put(self, table: str, key: bytes, value: bytes, dupsort: bool = False):
        t = self._own(table, key)
        existing = t[key]
        if existing is None:
            self._key_cache.pop(table, None)
        if dupsort:
            if existing is None:
                t[key] = [value]
            else:
                dups = existing if isinstance(existing, list) else [existing]
                t[key] = dups
                j = bisect.bisect_left(dups, value)
                if j >= len(dups) or dups[j] != value:
                    dups.insert(j, value)
        else:
            t[key] = value

    def delete(self, table: str, key: bytes, value: bytes | None = None) -> bool:
        t = self._own(table, key)
        existing = t[key]
        if existing is None:
            t[key] = _TOMBSTONE
            return False
        if value is None or not isinstance(existing, list):
            t[key] = _TOMBSTONE
            self._key_cache.pop(table, None)
            return True
        dups = existing
        j = bisect.bisect_left(dups, value)
        if j < len(dups) and dups[j] == value:
            dups.pop(j)
            if not dups:
                t[key] = _TOMBSTONE
                self._key_cache.pop(table, None)
            return True
        return False

    def clear(self, table: str):
        t = self.layer.setdefault(table, {})
        for k in self._sorted_keys(table):
            t[k] = _TOMBSTONE
        self._key_cache.pop(table, None)

    # -- lifecycle (no-ops: the layer IS the result) --------------------------

    def commit(self):
        pass

    def abort(self):
        pass


def apply_layer(tx: Tx, layer: Layer) -> None:
    """Persist one block's overlay layer into a real write transaction."""
    for table, entries in layer.items():
        for key, value in entries.items():
            if value is _TOMBSTONE or value is None:
                tx.delete(table, key)
            elif isinstance(value, list):
                tx.delete(table, key)
                for v in value:
                    tx.put(table, key, v, dupsort=True)
            else:
                tx.put(table, key, value)
