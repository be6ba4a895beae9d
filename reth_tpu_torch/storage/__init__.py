"""Storage layer: typed tables, KV transactions, cursors, providers.

A copy of the JAX package's ``storage`` package (the reference's
crates/storage/{db-api,db,provider}: the `Database`/`DbTx`/`DbCursorRO`
traits, the ~31-table typed schema and the `ProviderFactory` /
`DatabaseProvider` facade) with its three engines: the in-memory ``MemDb``
(optionally with a write-ahead log, ``wal.py``), and the native ``NativeDb``
and ``PagedDb`` (``native.py``, on the port's copies of the C++ engines).
``open_database`` opens the store a datadir's backend names, in the layout
the datadir recorded (``settings.py``).
"""

from .kv import Database, Tx, Cursor, MemDb
from .tables import Tables, TableDef
from .provider import ProviderFactory, DatabaseProvider

# backend name -> on-disk store name inside a datadir (the single source
# of truth shared by the CLI, the node builder, and tests)
DB_STORES = {"memdb": "db.bin", "native": "nativedb", "paged": "pageddb"}


def db_store_path(backend: str, datadir):
    from pathlib import Path

    return Path(datadir) / DB_STORES[backend]


def store_initialised(backend: str, datadir) -> bool:
    """True when ``datadir`` holds a store for ``backend`` that has ever
    been WRITTEN — mere directory existence is not enough, because every
    engine creates its files as a side effect of an open (a stale
    auto-created empty store must never mask an initialised one)."""
    path = db_store_path(backend, datadir)
    if backend == "memdb":  # snapshot file written on first flush
        return path.is_file() and path.stat().st_size > 0
    if backend == "paged":  # fresh store = the two 4 KiB meta pages only
        data = path / "data.rtpg"
        return data.is_file() and data.stat().st_size > 2 * 4096
    if backend == "native":  # a compacted snapshot or a non-empty WAL
        snap, wal = path / "snapshot.rtkv", path / "wal.rtkv"
        return snap.is_file() or (wal.is_file() and wal.stat().st_size > 0)
    return False


def _open_store(backend: str, datadir, suffix: str = ""):
    if backend == "native" and datadir is not None:
        from .native import NativeDb
        from pathlib import Path

        return NativeDb(Path(str(db_store_path(backend, datadir)) + suffix))
    if backend == "paged" and datadir is not None:
        from .native import PagedDb
        from pathlib import Path

        return PagedDb(Path(str(db_store_path(backend, datadir)) + suffix))
    if datadir is not None:
        from pathlib import Path

        p = db_store_path("memdb", datadir)
        return MemDb(p.with_name(p.stem + suffix + p.suffix) if suffix else p)
    return MemDb(None)


def open_database(backend: str, datadir, storage_v2: bool | None = None):
    """Open (creating if absent) the store for ``backend`` in ``datadir``.
    ``datadir`` None yields an ephemeral MemDb regardless of backend (the
    persistent engines need a directory).

    ``storage_v2`` requests the split layout (reference StorageSettings
    storage-v2: history/lookup tables on a dedicated second store,
    crates/storage/provider/src/providers/rocksdb/). The layout is
    PERSISTED per datadir on first open; an existing datadir keeps its
    recorded layout regardless of later flags."""
    db = _open_store(backend, datadir)
    from .settings import SplitDb, StorageSettings, read_settings, write_settings

    persisted = read_settings(db)
    if persisted is None:
        want_v2 = bool(storage_v2)
        if want_v2 and datadir is not None and store_initialised(backend, datadir):
            # an initialised row-less datadir is a v1 layout (legacy or
            # default): its history already lives in the main store, so a
            # silent upgrade would make every history read miss
            raise ValueError(
                "datadir already initialised with the v1 layout; "
                "--storage.v2 applies to fresh datadirs only")
        settings = StorageSettings(storage_v2=want_v2)
        # v1 stays IMPLICIT (absence of the row): writing on every open
        # would mark stale auto-created stores as initialised and break
        # backend resolution; only the v2 opt-in is persisted
        if settings.storage_v2:
            write_settings(db, settings)
    else:
        settings = persisted  # the datadir's recorded layout wins
    if not settings.storage_v2:
        return db
    return SplitDb(db, _open_store(backend, datadir, suffix="-aux"))


__all__ = [
    "DB_STORES",
    "db_store_path",
    "open_database",
    "Database",
    "Tx",
    "Cursor",
    "MemDb",
    "Tables",
    "TableDef",
    "ProviderFactory",
    "DatabaseProvider",
]
