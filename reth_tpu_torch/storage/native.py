"""ctypes bindings for the native C++ KV engines.

A copy of the JAX package's ``storage/native.py`` on the port's own copies of
the engines, ``csrc/kvstore.cpp`` (byte for byte the reference's) and
``csrc/pagedkv.cpp``, built by ``ops/_build.py``'s g++ route into
``reth_tpu_torch/build/`` at first use. A failed build raises
``NativeBuildError``, a ``BuildError``; nothing is built or loaded from the
JAX package's tree. The paged engine's copy differs in one respect: it
reserves its 1 TiB of address space as an anonymous PROT_NONE mapping and
maps the data file over its front as the file grows, where the reference
maps the file over the whole reservation (a machine that counts a file
mapping's length as resident memory kills a process holding that). The
engines write the same files for the same commits, so a store written by
either package opens in the other.

Two engines share one Database/Tx/Cursor duck interface (same as ``MemDb``):

* ``NativeDb`` — csrc/kvstore.cpp: in-RAM sorted tables + WAL/snapshot
  durability. Reference analogue: the in-memory half of libmdbx-rs usage.
* ``PagedDb`` — csrc/pagedkv.cpp: mmap-read copy-on-write paged B+tree
  with dual-meta commits, the real MDBX architecture analogue (shadow
  paging, O(1) crash recovery, nothing resident in process RAM).

Each engine exports the same C ABI under its own prefix (``rtkv_`` /
``rtpg_``); ``_Api`` normalizes them for the Python classes.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from ..ops._build import PKG_DIR, BuildError, load

_SRC_DIR = PKG_DIR / "csrc"
_build_lock = threading.Lock()
_apis: dict = {}


class NativeBuildError(BuildError):
    """A native engine failed to build or to open its store."""


class _Api:
    """Prefix-normalized function table for one engine's shared library."""

    _FUNCS = [
        "open", "close", "snapshot", "sync", "txn_begin", "put", "del",
        "clear", "get", "entry_count", "commit", "abort", "cursor",
        "cursor_close", "cursor_first", "cursor_last", "cursor_seek",
        "cursor_next", "cursor_prev", "cursor_next_dup", "cursor_seek_dup",
    ]

    def __init__(self, lib: ctypes.CDLL, prefix: str):
        for name in self._FUNCS:
            # "del" is a Python keyword: expose as del_
            setattr(self, name if name != "del" else "del_",
                    getattr(lib, f"{prefix}_{name}"))


def _load_api(src_name: str, prefix: str) -> _Api:
    if prefix in _apis:
        return _apis[prefix]
    with _build_lock:
        if prefix in _apis:
            return _apis[prefix]
        try:
            lib = load(_SRC_DIR / src_name)
        except BuildError as e:
            if isinstance(e, NativeBuildError):
                raise
            raise NativeBuildError(str(e)) from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        p = prefix
        f = lambda n: getattr(lib, f"{p}_{n}")  # noqa: E731
        f("open").restype = ctypes.c_void_p
        f("open").argtypes = [ctypes.c_char_p]
        f("close").argtypes = [ctypes.c_void_p]
        f("snapshot").argtypes = [ctypes.c_void_p]
        f("txn_begin").restype = ctypes.c_void_p
        f("txn_begin").argtypes = [ctypes.c_void_p, ctypes.c_int]
        f("put").argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p,
                             ctypes.c_uint32, u8p, ctypes.c_uint32, ctypes.c_int]
        f("del").argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p,
                             ctypes.c_uint32, u8p, ctypes.c_uint32, ctypes.c_int]
        f("clear").argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        f("get").argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p,
                             ctypes.c_uint32, ctypes.POINTER(u8p),
                             ctypes.POINTER(ctypes.c_uint32)]
        f("entry_count").restype = ctypes.c_uint64
        f("entry_count").argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        f("commit").argtypes = [ctypes.c_void_p]
        f("abort").argtypes = [ctypes.c_void_p]
        f("sync").argtypes = [ctypes.c_void_p]
        f("cursor").restype = ctypes.c_void_p
        f("cursor").argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        f("cursor_close").argtypes = [ctypes.c_void_p]
        out4 = [ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint32)]
        f("cursor_first").argtypes = [ctypes.c_void_p] + out4
        f("cursor_last").argtypes = [ctypes.c_void_p] + out4
        f("cursor_seek").argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                                     ctypes.c_int] + out4
        f("cursor_next").argtypes = [ctypes.c_void_p, ctypes.c_int] + out4
        f("cursor_prev").argtypes = [ctypes.c_void_p] + out4
        f("cursor_next_dup").argtypes = [ctypes.c_void_p] + out4
        f("cursor_seek_dup").argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_uint32, u8p, ctypes.c_uint32] + out4
        api = _Api(lib, prefix)
        _apis[prefix] = api
        return api


def load_library():
    """Backwards-compatible loader for the WAL engine's API table."""
    return _load_api("kvstore.cpp", "rtkv")


def _buf(b: bytes):
    return (ctypes.c_uint8 * len(b)).from_buffer_copy(b) if b else None


class NativeCursor:
    """Cursor over one table; same surface as storage.kv.Cursor."""

    def __init__(self, tx: "NativeTx", table: str):
        self._api = tx._api
        self._tx = tx  # keep the txn alive for the cursor's lifetime
        self._cur = self._api.cursor(tx._txn, table.encode())
        self._out = (
            ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_uint32(),
            ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_uint32(),
        )

    def __del__(self):
        try:
            self._api.cursor_close(self._cur)
        except Exception:
            pass

    def _ret(self, rc: int):
        if not rc:
            return None
        kp, kl, vp, vl = self._out
        key = ctypes.string_at(kp, kl.value) if kl.value else b""
        val = ctypes.string_at(vp, vl.value) if vl.value else b""
        return (key, val)

    def _refs(self):
        kp, kl, vp, vl = self._out
        return (ctypes.byref(kp), ctypes.byref(kl), ctypes.byref(vp), ctypes.byref(vl))

    def first(self):
        return self._ret(self._api.cursor_first(self._cur, *self._refs()))

    def last(self):
        return self._ret(self._api.cursor_last(self._cur, *self._refs()))

    def seek(self, key: bytes):
        return self._ret(self._api.cursor_seek(
            self._cur, _buf(key), len(key), 0, *self._refs()))

    def seek_exact(self, key: bytes):
        return self._ret(self._api.cursor_seek(
            self._cur, _buf(key), len(key), 1, *self._refs()))

    def next(self):
        return self._ret(self._api.cursor_next(self._cur, 0, *self._refs()))

    def prev(self):
        return self._ret(self._api.cursor_prev(self._cur, *self._refs()))

    def next_dup(self):
        return self._ret(self._api.cursor_next_dup(self._cur, *self._refs()))

    def next_no_dup(self):
        return self._ret(self._api.cursor_next(self._cur, 1, *self._refs()))

    def seek_by_key_subkey(self, key: bytes, subkey: bytes):
        return self._ret(self._api.cursor_seek_dup(
            self._cur, _buf(key), len(key), _buf(subkey), len(subkey), *self._refs()))

    def walk(self, start: bytes | None = None):
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
        for key, value in self.walk(start):
            if key >= end:
                return
            yield (key, value)


class NativeTx:
    def __init__(self, db: "NativeDb", write: bool):
        self._db = db
        self._api = db._api
        seen = db._commit_state()
        self._txn = self._api.txn_begin(db._env, 1 if write else 0)
        if not self._txn:
            raise RuntimeError("nested write transaction on one thread")
        self._write = write
        # the committed state this read transaction sees, when no commit
        # ran while it began (None: unknown; its key index is its own)
        self._state = seen[0] if not write and seen[1] == 0 \
            and db._commit_state() == seen else None
        self._key_cache: dict[str, list[bytes]] = {}
        self._done = False

    def get(self, table: str, key: bytes):
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint32()
        rc = self._api.get(self._txn, table.encode(), _buf(key), len(key),
                                ctypes.byref(out), ctypes.byref(out_len))
        if not rc:
            return None
        return ctypes.string_at(out, out_len.value) if out_len.value else b""

    def get_dups(self, table: str, key: bytes) -> list[bytes]:
        return [v for _, v in self.cursor(table).walk_dup(key)]

    def seek_dup(self, table: str, key: bytes, subkey: bytes) -> bytes | None:
        """The first duplicate of ``key`` whose value >= ``subkey`` (the
        port's provider and proof calculator look subkeys up through
        ``seek_dup``, as on ``MemDb``'s ``Tx``)."""
        entry = self.cursor(table).seek_by_key_subkey(key, subkey)
        return entry[1] if entry is not None else None

    def cursor(self, table: str) -> NativeCursor:
        return NativeCursor(self, table)

    def entry_count(self, table: str) -> int:
        return int(self._api.entry_count(self._txn, table.encode()))

    def _sorted_keys(self, table: str) -> list[bytes]:
        # cached per transaction, and for a read transaction of a known
        # committed state also on the database for the read transactions
        # of that state (with MVCC snapshots, one state's key set must not
        # reach another's view); callers do not modify the list
        cached = self._key_cache.get(table)
        if cached is not None:
            return cached
        keys = self._db._state_keys(self._state, table)
        if keys is None:
            keys = []
            cur = self.cursor(table)
            entry = cur.first()
            while entry is not None:
                keys.append(entry[0])
                entry = cur.next_no_dup()
            self._db._keep_state_keys(self._state, table, keys)
        self._key_cache[table] = keys
        return keys

    def put(self, table: str, key: bytes, value: bytes, dupsort: bool = False):
        assert self._write, "read-only transaction"
        self._key_cache.pop(table, None)
        self._api.put(self._txn, table.encode(), _buf(key), len(key),
                           _buf(value), len(value), 1 if dupsort else 0)

    def delete(self, table: str, key: bytes, value: bytes | None = None) -> bool:
        assert self._write, "read-only transaction"
        self._key_cache.pop(table, None)
        if value is None:
            return bool(self._api.del_(self._txn, table.encode(), _buf(key),
                                       len(key), None, 0, 0))
        return bool(self._api.del_(self._txn, table.encode(), _buf(key),
                                   len(key), _buf(value), len(value), 1))

    def clear(self, table: str):
        assert self._write
        self._key_cache.pop(table, None)
        self._api.clear(self._txn, table.encode())

    def commit(self):
        assert not self._done
        self._db._commit_begins()
        try:
            rc = self._api.commit(self._txn)
        finally:
            self._db._commit_ends()
        self._done = True
        if rc != 0:
            raise OSError("native KV commit failed (WAL write error)")

    def abort(self):
        if not self._done:
            self._api.abort(self._txn)  # MVCC: clones just drop
            self._done = True

    def __del__(self):
        # read txns are routinely dropped without commit (provider reads);
        # abort frees the C++ Txn (no-op rollback for read-only)
        try:
            self.abort()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if not self._done:
            if exc_type is None and self._write:
                self.commit()
            else:
                self.abort()


class NativeDb:
    """Database over the C++ engine (persistent when ``path`` given).

    Commits are counted, each bracketed by an in-flight count, so a read
    transaction that began while none ran knows the committed state it sees
    (``_commit_state``); the sorted key index of a table at the newest such
    state is kept for every read transaction of it (a fresh view's cursor
    otherwise walks the whole table)."""

    def __init__(self, path: str | Path | None = None):
        self._api = load_library()
        self._init_index()
        self._dir = str(path) if path else ""
        if path:
            Path(path).mkdir(parents=True, exist_ok=True)
        self._env = self._api.open(self._dir.encode())
        if not self._env:
            raise NativeBuildError(f"rtkv_open failed for {self._dir!r}")

    def _init_index(self) -> None:
        self._commits = 0   # commits ended
        self._inflight = 0  # commits running
        self._index: tuple[int, dict[str, list[bytes]]] = (-1, {})
        self._lock = threading.Lock()

    def _commit_state(self) -> tuple[int, int]:
        with self._lock:
            return self._commits, self._inflight

    def _commit_begins(self) -> None:
        with self._lock:
            self._inflight += 1

    def _commit_ends(self) -> None:
        with self._lock:
            self._inflight -= 1
            self._commits += 1

    def _state_keys(self, state: int | None, table: str) -> list[bytes] | None:
        if state is None:
            return None
        at, tables = self._index
        return tables.get(table) if at == state else None

    def _keep_state_keys(self, state: int | None, table: str, keys: list[bytes]) -> None:
        if state is None:
            return
        with self._lock:
            at, tables = self._index
            if at == state:
                tables[table] = keys
            elif state > at:
                self._index = (state, {table: keys})

    def tx(self) -> NativeTx:
        return NativeTx(self, write=False)

    def tx_mut(self) -> NativeTx:
        return NativeTx(self, write=True)

    def flush(self):
        """Compact the WAL into a snapshot (fsynced)."""
        if self._api.snapshot(self._env) != 0:
            raise OSError("native KV snapshot failed")

    def sync(self):
        """Power-loss durability point: fsync the WAL."""
        if self._api.sync(self._env) != 0:
            raise OSError("native KV sync failed")

    def close(self):
        if self._env:
            self._api.close(self._env)
            self._env = None


class PagedDb(NativeDb):
    """Database over the paged copy-on-write B+tree engine (pagedkv.cpp).

    The MDBX architecture analogue: reads go through one shared mmap (the
    OS page cache is the read cache), commits are shadow-paged with a dual
    meta-page flip, and crash recovery is O(1) — the previous meta is
    always intact. Persistent-only: a directory path is required.
    """

    def __init__(self, path: str | Path):
        self._api = _load_api("pagedkv.cpp", "rtpg")
        self._init_index()
        self._dir = str(path)
        Path(path).mkdir(parents=True, exist_ok=True)
        self._env = self._api.open(self._dir.encode())
        if not self._env:
            raise NativeBuildError(f"rtpg_open failed for {self._dir!r}")

    def flush(self):
        """Durability point (every commit already fsyncs the meta flip)."""
        if self._api.snapshot(self._env) != 0:
            raise OSError("paged KV sync failed")
