"""Storage-V2: history/lookup tables on a dedicated second store.

A copy of the JAX package's ``storage/settings.py``; ``check_consistency``
refilters history shards through the port's
``stages/index_history._unwind_shards``. ``SplitTx`` also routes
``seek_dup``, the subkey lookup the port's provider makes.

Reference analogue: the RocksDB storage-v2 provider
(crates/storage/provider/src/providers/rocksdb/provider.rs:28-40) —
`StorageSettings.storage_v2` moves `TransactionHashNumbers`,
`AccountsHistory`/`StoragesHistory` and the changesets out of MDBX into
a column-family store tuned for their write pattern, and
`invariants.rs` reconciles that store against the stage checkpoints on
startup (ahead ⇒ heal by pruning, behind ⇒ unwind target).

Here the second store is another instance of the SAME engine family
(the paged COW B+tree already supports many trees; a separate FILE is
the column-family boundary), behind a :class:`SplitDb` router that
implements the ordinary ``Database`` interface — every provider,
stage, and RPC path works unchanged on either layout. Commits are
aux-first then main: a crash between the two leaves the aux store
AHEAD of the checkpoints, exactly the direction ``check_consistency``
heals (the reference recovers RocksDB↔MDBX divergence the same way).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from .kv import Cursor, Database, Tx
from .tables import Tables, be64, from_be64

# tables that move to the aux store under storage-v2 (reference
# ROCKSDB_TABLES, providers/rocksdb/provider.rs)
V2_TABLES = frozenset({
    Tables.TransactionHashNumbers.name,
    Tables.AccountsHistory.name,
    Tables.StoragesHistory.name,
    Tables.AccountChangeSets.name,
    Tables.StorageChangeSets.name,
})

_SETTINGS_KEY = b"storage_settings"


@dataclass(frozen=True)
class StorageSettings:
    """Persisted per-datadir layout switches (reference
    `StorageSettings`, crates/storage/db-api/src/models)."""

    storage_v2: bool = False

    def to_json(self) -> str:
        return json.dumps({"storage_v2": self.storage_v2})

    @classmethod
    def from_json(cls, raw: str) -> "StorageSettings":
        d = json.loads(raw)
        return cls(storage_v2=bool(d.get("storage_v2", False)))


def read_settings(db: Database) -> StorageSettings | None:
    with db.tx() as tx:
        raw = tx.get(Tables.Metadata.name, _SETTINGS_KEY)
    return StorageSettings.from_json(raw.decode()) if raw is not None else None


def write_settings(db: Database, settings: StorageSettings) -> None:
    tx = db.tx_mut()
    tx.put(Tables.Metadata.name, _SETTINGS_KEY, settings.to_json().encode())
    tx.commit()


_EPOCH_KEY = b"split_commit_epoch"


class SplitTx:
    """Routes table operations to the main or aux transaction."""

    def __init__(self, main: Tx, aux: Tx, db: "SplitDb | None" = None,
                 write: bool = False):
        self._main = main
        self._aux = aux
        self._db = db
        self._write = write

    def _t(self, table: str) -> Tx:
        return self._aux if table in V2_TABLES else self._main

    def __getattr__(self, name):
        # engine-internal views the overlay layer probes with hasattr()
        # (MemDb fast paths): forward them table-routed, but ONLY when the
        # underlying engine actually has them — a plain method here would
        # make hasattr() lie for the native C++ backends
        if name in ("_table", "_sorted_keys"):
            if not hasattr(self._main, name):
                raise AttributeError(name)

            def fwd(table, _name=name):
                return getattr(self._t(table), _name)(table)

            return fwd
        raise AttributeError(name)

    def get(self, table, key):
        return self._t(table).get(table, key)

    def get_dups(self, table, key):
        return self._t(table).get_dups(table, key)

    def seek_dup(self, table, key, subkey):
        return self._t(table).seek_dup(table, key, subkey)

    def cursor(self, table) -> Cursor:
        return self._t(table).cursor(table)

    def entry_count(self, table) -> int:
        return self._t(table).entry_count(table)

    def put(self, table, key, value, dupsort: bool = False):
        return self._t(table).put(table, key, value, dupsort)

    def delete(self, table, key, value=None):
        return self._t(table).delete(table, key, value)

    def clear(self, table):
        return self._t(table).clear(table)

    def commit(self):
        # every write commit stamps BOTH stores with the same epoch, aux
        # first: a crash in between leaves aux one epoch ahead — the
        # exact signal check_consistency() keys its healing on
        if self._db is not None and self._write:
            epoch = self._db.next_epoch()
            self._aux.put(Tables.Metadata.name, _EPOCH_KEY, be64(epoch))
            self._main.put(Tables.Metadata.name, _EPOCH_KEY, be64(epoch))
        self._aux.commit()
        self._main.commit()

    def abort(self):
        self._aux.abort()
        self._main.abort()

    def __enter__(self):
        self._aux.__enter__()
        self._main.__enter__()
        return self

    def __exit__(self, exc_type, *a):
        self._aux.__exit__(exc_type, *a)
        self._main.__exit__(exc_type, *a)


class SplitDb(Database):
    """The storage-v2 layout: a main store + a history/lookup store
    behind one ``Database`` face."""

    def __init__(self, main: Database, aux: Database):
        self.main = main
        self.aux = aux
        self._epoch = max(_read_epoch(main), _read_epoch(aux))

    def next_epoch(self) -> int:
        self._epoch += 1
        return self._epoch

    def tx(self) -> SplitTx:
        return SplitTx(self.main.tx(), self.aux.tx())

    def tx_mut(self) -> SplitTx:
        return SplitTx(self.main.tx_mut(), self.aux.tx_mut(),
                       db=self, write=True)

    def flush(self):
        for db in (self.aux, self.main):
            flush = getattr(db, "flush", None)
            if flush is not None:
                flush()

    def close(self):
        for db in (self.aux, self.main):
            close = getattr(db, "close", None)
            if close is not None:
                close()


# -- startup invariants (reference providers/rocksdb/invariants.rs) ----------


def _read_epoch(db: Database) -> int:
    with db.tx() as tx:
        raw = tx.get(Tables.Metadata.name, _EPOCH_KEY)
    return from_be64(raw) if raw else 0


def check_consistency(factory) -> int | None:
    """Reconcile the aux store against the main store on startup.

    A CLEAN datadir (both stores stamped with the same commit epoch —
    including every normal mid-sync restart, where stage checkpoints
    legitimately lag the canonical tip) passes with one cheap probe. A
    TORN commit (aux stamped one epoch ahead: the crash window of the
    aux-first commit order) triggers healing: orphaned lookup rows whose
    tx numbers exceed the committed tx space are pruned, history shards
    touched by the orphaned changesets are refiltered through the index
    stages' own shard surgery, and the orphaned changesets are dropped.
    The post-heal commit re-stamps both stores with one epoch. An aux
    store BEHIND the main store (lost aux data) returns an unwind target
    for the pipeline to rebuild from."""
    db = factory.db
    torn = _read_epoch(db.aux) != _read_epoch(db.main)
    healed_any = False
    with factory.provider_rw() as p:
        lookup_cp = p.stage_checkpoint("TransactionLookup") or 0
        tip = p.last_block_number()
        # cheap behind probe (always): the lookup rows for the checkpoint
        # block must exist — body insertion wrote them
        unwind: int | None = None
        idx = p.block_body_indices(lookup_cp) if lookup_cp else None
        if lookup_cp and idx and idx.tx_count > 0:
            txs = p.transactions_by_block(lookup_cp) or []
            if txs and p.tx.get(Tables.TransactionHashNumbers.name,
                                txs[-1].hash) is None:
                unwind = _last_indexed_block(p, lookup_cp)

        if torn:
            exec_cp = p.stage_checkpoint("Execution") or 0
            acct_hist_cp = p.stage_checkpoint("IndexAccountHistory") or 0
            stor_hist_cp = p.stage_checkpoint("IndexStorageHistory") or 0
            # orphaned lookup rows: their tx numbers lie beyond the
            # committed tx space (the bodies were never committed, so the
            # rows are unreachable by any canonical path)
            idx_tip = p.block_body_indices(tip)
            max_tx = idx_tip.next_tx_num - 1 if idx_tip else -1
            cur = p.tx.cursor(Tables.TransactionHashNumbers.name)
            doomed = []
            item = cur.first()
            while item is not None:
                if from_be64(item[1]) > max_tx:
                    doomed.append(bytes(item[0]))
                item = cur.next()
            for k in doomed:
                p.tx.delete(Tables.TransactionHashNumbers.name, k)
                healed_any = True
            # history shards: gather prefixes from the orphaned window's
            # changesets FIRST (they may reference blocks above the tip),
            # refilter through the index stages' own shard surgery, THEN
            # drop the orphaned changesets
            far = (1 << 48)
            from ..stages.index_history import _unwind_shards

            for addr in _account_prefixes_in_window(p, acct_hist_cp, far):
                _unwind_shards(p, Tables.AccountsHistory.name, addr,
                               acct_hist_cp + 1)
                healed_any = True
            for prefix in _storage_prefixes_in_window(p, stor_hist_cp, far):
                _unwind_shards(p, Tables.StoragesHistory.name, prefix,
                               stor_hist_cp + 1)
                healed_any = True
            healed_any |= _prune_changesets_above(p, exec_cp)
    # the provider commit above went through SplitTx.commit, which stamps
    # BOTH stores with a fresh shared epoch — the torn marker is cleared
    if healed_any or torn:
        factory.db.flush()
    return unwind


def _last_indexed_block(p, checkpoint: int, max_scan: int = 4096) -> int:
    """Highest block whose last tx hash IS present in the lookup table
    (the unwind target when the aux store is behind)."""
    n = checkpoint
    scanned = 0
    while n > 0 and scanned < max_scan:
        txs = p.transactions_by_block(n) or []
        if not txs:
            n -= 1
            scanned += 1
            continue
        if p.tx.get(Tables.TransactionHashNumbers.name,
                    txs[-1].hash) is not None:
            return n
        n -= 1
        scanned += 1
    return 0


def _account_prefixes_in_window(p, checkpoint: int, tip: int) -> set[bytes]:
    if tip <= checkpoint:
        return set()
    return set(p.account_changes_in_range(checkpoint + 1, tip))


def _storage_prefixes_in_window(p, checkpoint: int, tip: int) -> set[bytes]:
    if tip <= checkpoint:
        return set()
    out: set[bytes] = set()
    for addr, slots in p.storage_changes_in_range(checkpoint + 1, tip).items():
        for s in slots:
            out.add(addr + s)
    return out


def _prune_changesets_above(p, checkpoint: int) -> bool:
    """Changeset keys are be64(block)-prefixed: one seek past the
    checkpoint bounds the walk to the crash window."""
    healed = False
    for table in (Tables.AccountChangeSets.name,
                  Tables.StorageChangeSets.name):
        cur = p.tx.cursor(table)
        doomed = []
        item = cur.seek(be64(checkpoint + 1))
        while item is not None:
            doomed.append(bytes(item[0]))
            item = cur.next()
        for k in dict.fromkeys(doomed):
            p.tx.delete(table, k)  # value None drops every duplicate
            healed = True
    return healed
