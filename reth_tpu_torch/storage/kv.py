"""KV store abstraction: Database → Tx → Cursor, with DUPSORT tables.

A copy of the JAX package's ``storage/kv.py`` (the reference's
`Database`/`DbTx`/`DbTxMut`/`DbCursorRO/RW` traits over libmdbx,
crates/storage/db-api/src/{database,transaction,cursor}.rs). Semantics kept
from MDBX where they matter to callers:

- keys and values are raw ``bytes``; tables are sorted by key
- DUPSORT tables hold multiple values per key, sorted by value; a
  (key, subkey-prefixed value) model identical to the reference's use
- single-writer model (as MDBX enforces in the reference) WITH MVCC
  snapshot isolation: a transaction captures the published table map at
  begin; published table dicts are immutable (writers clone-on-first-
  write and publish by one atomic map swap at commit), so readers see a
  stable point-in-time view for their whole lifetime even while a
  writer commits — the semantics MDBX provides via shadow paging.

The in-memory ``MemDb`` keeps each table as ``dict[key -> value | sorted
value list]`` plus a per-transaction sorted key index, giving O(log n)
seeks and ordered iteration.

A ``MemDb`` may carry a write-ahead log (``storage/wal.py``, attached by
``attach_wal``): a write transaction then tracks the keys it touches and its
commit appends their final values as one fsync'd record before it publishes.
"""

from __future__ import annotations

import bisect
import pickle
import sys
import threading
from pathlib import Path

from .. import tracing
from .wal import fsync_dir, fsync_file

class Cursor:
    """Sorted cursor over one table (reference `DbCursorRO`/`DbDupCursorRO`).

    Positions on (key, value) pairs; for DUPSORT tables each duplicate is a
    separate position, ordered by (key, value).
    """

    def __init__(self, tx: "Tx", table: str):
        self._tx = tx
        self._table = table
        self._keys = tx._sorted_keys(table)
        self._ki = -1  # key index
        self._di = 0   # dup index within key

    # -- helpers ------------------------------------------------------------

    def _data(self):
        return self._tx._table(self._table)

    def _dups(self, key: bytes) -> list[bytes]:
        v = self._data().get(key)
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    def _current(self):
        if 0 <= self._ki < len(self._keys):
            key = self._keys[self._ki]
            dups = self._dups(key)
            if 0 <= self._di < len(dups):
                return (key, dups[self._di])
        return None

    # -- positioning --------------------------------------------------------

    def first(self):
        self._ki, self._di = (0, 0) if self._keys else (-1, 0)
        return self._current()

    def last(self):
        if not self._keys:
            self._ki = -1
            return None
        self._ki = len(self._keys) - 1
        self._di = len(self._dups(self._keys[self._ki])) - 1
        return self._current()

    def seek(self, key: bytes):
        """Position at the first entry with key >= ``key``."""
        self._ki = bisect.bisect_left(self._keys, key)
        self._di = 0
        return self._current()

    def seek_exact(self, key: bytes):
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            self._ki, self._di = i, 0
            return self._current()
        self._ki = len(self._keys)  # past end
        self._di = 0
        return None

    def next(self):
        if self._ki < 0:
            return self.first()
        if self._ki >= len(self._keys):
            return None
        dups = self._dups(self._keys[self._ki])
        if self._di + 1 < len(dups):
            self._di += 1
        else:
            self._ki += 1
            self._di = 0
        return self._current()

    def prev(self):
        if self._ki < 0:
            return None
        if self._di > 0:
            self._di -= 1
            return self._current()
        if self._ki == 0:
            self._ki = -1
            return None
        self._ki -= 1
        if self._ki < len(self._keys):
            self._di = len(self._dups(self._keys[self._ki])) - 1
        return self._current()

    # -- DUPSORT ------------------------------------------------------------

    def seek_by_key_subkey(self, key: bytes, subkey: bytes):
        """First duplicate of ``key`` whose value >= ``subkey`` (prefix seek)."""
        i = bisect.bisect_left(self._keys, key)
        if i >= len(self._keys) or self._keys[i] != key:
            self._ki = len(self._keys)
            return None
        dups = self._dups(key)
        j = bisect.bisect_left(dups, subkey)
        if j >= len(dups):
            return None
        self._ki, self._di = i, j
        return (key, dups[j])

    def next_dup(self):
        cur = self._current()
        if cur is None:
            return None
        dups = self._dups(self._keys[self._ki])
        if self._di + 1 < len(dups):
            self._di += 1
            return self._current()
        return None

    def next_no_dup(self):
        if self._ki < 0:
            return self.first()
        self._ki += 1
        self._di = 0
        return self._current()

    def walk(self, start: bytes | None = None):
        """Iterate (key, value) from ``start`` (or beginning) to the end."""
        entry = self.seek(start) if start is not None else self.first()
        while entry is not None:
            yield entry
            entry = self.next()

    def walk_dup(self, key: bytes, subkey: bytes = b""):
        entry = self.seek_by_key_subkey(key, subkey)
        while entry is not None:
            yield entry
            entry = self.next_dup()

    def walk_range(self, start: bytes, end: bytes):
        """Iterate entries with start <= key < end."""
        for key, value in self.walk(start):
            if key >= end:
                return
            yield (key, value)


_EMPTY_TABLE: dict = {}


class Tx:
    """A transaction with MVCC snapshot isolation.

    Begin captures the published name->table map; published table dicts are
    IMMUTABLE (writers clone a table on first touch and atomically swap the
    whole map on commit), so readers see a consistent point-in-time snapshot
    for their entire lifetime regardless of concurrent commits — the
    semantics MDBX gives the reference via shadow paging. One writer at a
    time (``MemDb._writer_lock``), matching MDBX's single write txn.
    """

    def __init__(self, db: "MemDb", write: bool):
        self._db = db
        self._write = write
        self._done = True  # until the writer lock is held
        if write:
            # nested write txns on one thread would silently clobber each
            # other's whole-table clones at commit — fail loudly instead
            if db._writer_thread == threading.get_ident():
                raise RuntimeError("nested write transaction on one thread")
            db._writer_lock.acquire()
            db._writer_thread = threading.get_ident()
        self._snap: dict[str, dict] = db._tables  # published map (immutable)
        self._own: dict[str, dict] = {}           # tx-private clones
        # per-table touched-key sets for the WAL's commit delta (value
        # None = whole-table replace via clear()); tracked only when a
        # WAL is attached so the no-WAL hot path stays allocation-free
        self._touched: dict[str, set | None] | None = \
            {} if (write and getattr(db, "_wal", None) is not None) else None
        self._key_cache: dict[str, list[bytes]] = {}
        self._done = False

    # -- table access --------------------------------------------------------

    def _table(self, table: str) -> dict:
        t = self._own.get(table)
        if t is not None:
            return t
        return self._snap.get(table, _EMPTY_TABLE)

    def _wtable(self, table: str) -> dict:
        t = self._own.get(table)
        if t is None:
            # deep-enough clone: dup lists are mutated in place by put/delete
            t = {
                k: (list(v) if isinstance(v, list) else v)
                for k, v in self._snap.get(table, _EMPTY_TABLE).items()
            }
            self._own[table] = t
        return t

    def _sorted_keys(self, table: str) -> list[bytes]:
        cached = self._key_cache.get(table)
        if cached is None:
            cached = sorted(self._table(table).keys())
            self._key_cache[table] = cached
        return cached

    def _invalidate_keys(self, table: str):
        self._key_cache.pop(table, None)

    def _track(self, table: str, key: bytes):
        t = self._touched
        if t is None:
            return
        s = t.get(table)
        if s is None:
            if table in t:
                return  # whole-table replace already recorded
            s = t[table] = set()
        s.add(key)

    def _commit_delta(self) -> dict:
        """The WAL record for this commit: per touched table, the final
        absolute values of written keys + the deleted keys (or the whole
        table for clear()) — exactly what the clone-on-touch write set
        materialized, frozen for serialization."""

        def freeze(v):
            return list(v) if isinstance(v, list) else v

        touched = self._touched or {}
        delta: dict[str, dict] = {}
        for table, own in self._own.items():
            keys = touched.get(table, None)
            if keys is None:
                # clear()ed (or untracked, defensively): record the whole
                # replacement table — replay-idempotent either way
                delta[table] = {"replace": True,
                                "rows": {k: freeze(v) for k, v in own.items()}}
            else:
                rows, dels = {}, []
                for k in keys:
                    if k in own:
                        rows[k] = freeze(own[k])
                    else:
                        dels.append(k)
                delta[table] = {"rows": rows, "del": dels}
        return delta

    # -- reads --------------------------------------------------------------

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
        """The first duplicate of ``key`` whose value >= ``subkey``: the
        value ``cursor(table).seek_by_key_subkey(key, subkey)`` lands on,
        found without the cursor's sorted key index (a cursor made after a
        new key re-sorts the whole table's keys)."""
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
        for v in self._table(table).values():
            n += len(v) if isinstance(v, list) else 1
        return n

    # -- writes -------------------------------------------------------------

    def put(self, table: str, key: bytes, value: bytes, dupsort: bool = False):
        assert self._write, "read-only transaction"
        t = self._wtable(table)
        self._track(table, key)
        if key not in t:
            self._invalidate_keys(table)
        if dupsort:
            dups = t.get(key)
            if dups is None:
                t[key] = [value]
            else:
                if not isinstance(dups, list):
                    dups = [dups]
                    t[key] = dups
                j = bisect.bisect_left(dups, value)
                if j >= len(dups) or dups[j] != value:
                    dups.insert(j, value)
        else:
            t[key] = value

    def delete(self, table: str, key: bytes, value: bytes | None = None):
        """Delete a key (or one duplicate when ``value`` given)."""
        assert self._write, "read-only transaction"
        t = self._wtable(table)
        self._track(table, key)
        if key not in t:
            return False
        if value is None or not isinstance(t.get(key), list):
            del t[key]
            self._invalidate_keys(table)
            return True
        dups = t[key]
        j = bisect.bisect_left(dups, value)
        if j < len(dups) and dups[j] == value:
            dups.pop(j)
            if not dups:
                del t[key]
                self._invalidate_keys(table)
            return True
        return False

    def clear(self, table: str):
        assert self._write
        self._own[table] = {}
        if self._touched is not None:
            self._touched[table] = None  # whole-table replace in the WAL
        self._invalidate_keys(table)

    # -- lifecycle ----------------------------------------------------------

    def commit(self):
        assert not self._done
        if not self._write:
            self._done = True
            return
        try:
            if self._own:
                def _publish():
                    new_map = dict(self._db._tables)
                    new_map.update(self._own)
                    # atomic publish (GIL reference swap)
                    self._db._tables = new_map
                    self._db._dirty = True

                wal = getattr(self._db, "_wal", None)
                if wal is not None and self._touched is not None:
                    # durability boundary: the fsync'd WAL record lands
                    # BEFORE the in-memory publish (and under the WAL
                    # lock, so a concurrent checkpoint can never truncate
                    # a record whose state it did not snapshot)
                    wal.append(self._commit_delta(), publish=_publish)
                else:
                    _publish()
        finally:
            # a failed append (ENOSPC/EIO) must not leave the writer
            # lock held until __del__: the commit raises, but the txn is
            # over either way (the WAL already rewound its segment)
            self._done = True
            self._db._writer_thread = None
            self._db._writer_lock.release()

    def abort(self):
        if self._write and not self._done:
            self._db._writer_thread = None
            self._db._writer_lock.release()
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if not self._done:
            if exc_type is None and self._write:
                self.commit()
            else:
                self.abort()

    def __del__(self):
        if not self._done and self._write:
            try:
                self._db._writer_thread = None
                self._db._writer_lock.release()
            except RuntimeError:
                pass


class Database:
    """Factory of transactions (reference `Database` trait)."""

    def tx(self) -> Tx:
        raise NotImplementedError

    def tx_mut(self) -> Tx:
        raise NotImplementedError


class MemDb(Database):
    """In-memory store, optionally persisted to a file (test/dev backend).

    Reference analogue: `create_test_rw_db` temp MDBX environments
    (crates/storage/db/src/test_utils). Persistence is whole-image
    pickle save/load. An unreadable image is moved aside (``quarantined``)
    and the store starts empty.
    """

    def __init__(self, path: str | Path | None = None):
        self._tables: dict[str, dict[bytes, object]] = {}
        self._writer_lock = threading.Lock()
        self._writer_thread: int | None = None
        self._path = Path(path) if path else None
        self._dirty = False
        self.quarantined: Path | None = None
        self._wal = None          # WalStore once storage/wal.py attaches
        if self._path and self._path.exists():
            try:
                with open(self._path, "rb") as f:
                    self._tables = pickle.load(f)
            except Exception as e:  # noqa: BLE001 - unreadable/truncated image
                self.quarantined = self._quarantine_image(e)

    def _quarantine_image(self, err: Exception) -> Path:
        k = 0
        while True:
            dest = self._path.with_name(f"{self._path.name}.corrupt-{k}")
            if not dest.exists():
                break
            k += 1
        self._path.replace(dest)
        self._tables = {}
        try:
            tracing.event("storage::kv", "image_quarantined",
                          path=str(self._path), quarantined=str(dest),
                          error=f"{type(err).__name__}: {err}")
        except Exception:  # noqa: BLE001 - telemetry never gates startup
            pass
        print(f"memdb: corrupt image {self._path} quarantined to {dest} "
              f"({type(err).__name__}: {err}); recovering from WAL/genesis",
              file=sys.stderr)
        return dest

    def tx(self) -> Tx:
        return Tx(self, write=False)

    def tx_mut(self) -> Tx:
        return Tx(self, write=True)

    def flush(self):
        if self._path and self._dirty:
            tmp = self._path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(self._tables, f, protocol=pickle.HIGHEST_PROTOCOL)
                # fsync the bytes BEFORE the rename and the directory
                # AFTER it: without both, a crash shortly after replace()
                # can still surface the old (or no) image
                fsync_file(f)
            tmp.replace(self._path)
            fsync_dir(self._path.parent)
            self._dirty = False
