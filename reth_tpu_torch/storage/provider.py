"""Provider facade: typed read/write over the KV store.

A copy of the JAX package's ``storage/provider.py`` (the reference's
`ProviderFactory` → `DatabaseProvider`
(crates/storage/provider/src/providers/database/mod.rs) and the
capability traits in crates/storage/storage-api (BlockReader,
StateProvider, HashingWriter, TrieWriter, StageCheckpointReader…).
One provider class carries the trait surface; callers depend on the
method subset they need, so a future split into protocol classes is
non-breaking.

Static files (``static_files=``) are not ported yet (ROADMAP A item 8): any
value but None raises ``NotImplementedError``. The DUPSORT subkey lookups
(``_replace_dup``, ``_get_dup``) go through ``Tx.seek_dup``, which lands on
the duplicate a cursor's ``seek_by_key_subkey`` would, without a cursor.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..primitives.types import Account, Block, Header, Receipt, Transaction, Withdrawal
from ..primitives.rlp import rlp_encode, rlp_decode, decode_int
from .kv import Database, Tx
from . import tables as T
from .tables import Tables, be64, from_be64


@dataclass(frozen=True)
class BlockBodyIndices:
    first_tx_num: int
    tx_count: int

    @property
    def last_tx_num(self) -> int:
        return self.first_tx_num + self.tx_count - 1

    @property
    def next_tx_num(self) -> int:
        return self.first_tx_num + self.tx_count


_NO_STATIC_FILES = "static files are not ported yet (ROADMAP A item 8)"


class DatabaseProvider:
    """A transaction-scoped typed view of the database."""

    def __init__(self, tx: Tx, static_files=None):
        if static_files is not None:
            raise NotImplementedError(_NO_STATIC_FILES)
        self.tx = tx

    # -- lifecycle -----------------------------------------------------------

    def commit(self):
        self.tx.commit()

    def abort(self):
        self.tx.abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.commit()
        else:
            self.abort()

    # -- headers / canonical chain -------------------------------------------

    def insert_header(self, header: Header):
        num = be64(header.number)
        h = header.hash
        self.tx.put(Tables.Headers.name, num, T.encode_header(header))
        self.tx.put(Tables.CanonicalHeaders.name, num, h)
        self.tx.put(Tables.HeaderNumbers.name, h, num)

    def header_by_number(self, number: int) -> Header | None:
        raw = self.tx.get(Tables.Headers.name, be64(number))
        return T.decode_header(raw) if raw else None

    def canonical_hash(self, number: int) -> bytes | None:
        return self.tx.get(Tables.CanonicalHeaders.name, be64(number))

    def block_number(self, block_hash: bytes) -> int | None:
        raw = self.tx.get(Tables.HeaderNumbers.name, block_hash)
        return from_be64(raw) if raw else None

    def last_block_number(self) -> int:
        cur = self.tx.cursor(Tables.CanonicalHeaders.name)
        last = cur.last()
        return from_be64(last[0]) if last else 0

    # -- bodies --------------------------------------------------------------

    def insert_block_body(self, block: Block):
        """Store txs/ommers/withdrawals; assigns sequential tx numbers."""
        number = block.header.number
        first_tx = self._next_tx_num()
        for i, tx in enumerate(block.transactions):
            tx_num = be64(first_tx + i)
            self.tx.put(Tables.Transactions.name, tx_num, T.encode_tx(tx))
            self.tx.put(Tables.TransactionHashNumbers.name, tx.hash, tx_num)
        count = len(block.transactions)
        self.tx.put(
            Tables.BlockBodyIndices.name,
            be64(number),
            be64(first_tx) + be64(count),
        )
        if count:
            self.tx.put(Tables.TransactionBlocks.name, be64(first_tx + count - 1), be64(number))
        if block.ommers:
            self.tx.put(
                Tables.BlockOmmers.name, be64(number),
                rlp_encode([o.rlp_fields() for o in block.ommers]),
            )
        if block.withdrawals is not None:
            self.tx.put(
                Tables.BlockWithdrawals.name, be64(number),
                rlp_encode([w.rlp_fields() for w in block.withdrawals]),
            )

    def _next_tx_num(self) -> int:
        cur = self.tx.cursor(Tables.Transactions.name)
        last = cur.last()
        return from_be64(last[0]) + 1 if last else 0

    def block_body_indices(self, number: int) -> BlockBodyIndices | None:
        raw = self.tx.get(Tables.BlockBodyIndices.name, be64(number))
        if raw is None:
            return None
        return BlockBodyIndices(from_be64(raw[:8]), from_be64(raw[8:16]))

    def transactions_by_block(self, number: int) -> list[Transaction] | None:
        idx = self.block_body_indices(number)
        if idx is None:
            return None
        out = []
        for i in range(idx.first_tx_num, idx.next_tx_num):
            raw = self.tx.get(Tables.Transactions.name, be64(i))
            if raw is None:
                raise KeyError(f"missing tx number {i}")
            out.append(T.decode_tx(raw))
        return out

    def block_by_number(self, number: int) -> Block | None:
        header = self.header_by_number(number)
        if header is None:
            return None
        txs = self.transactions_by_block(number) or []
        withdrawals = None
        raw_w = self.tx.get(Tables.BlockWithdrawals.name, be64(number))
        if raw_w is not None:
            withdrawals = tuple(
                Withdrawal(decode_int(w[0]), decode_int(w[1]), w[2], decode_int(w[3]))
                for w in rlp_decode(raw_w)
            )
        ommers = ()
        raw_o = self.tx.get(Tables.BlockOmmers.name, be64(number))
        if raw_o is not None:
            ommers = tuple(Header.decode_fields(f) for f in rlp_decode(raw_o))
        return Block(header, tuple(txs), ommers, withdrawals)

    # -- senders / receipts ----------------------------------------------------

    def put_sender(self, tx_num: int, sender: bytes):
        self.tx.put(Tables.TransactionSenders.name, be64(tx_num), sender)

    def sender(self, tx_num: int) -> bytes | None:
        return self.tx.get(Tables.TransactionSenders.name, be64(tx_num))

    def put_receipt(self, tx_num: int, receipt: Receipt):
        self.tx.put(Tables.Receipts.name, be64(tx_num), T.encode_receipt(receipt))

    def receipt(self, tx_num: int) -> Receipt | None:
        raw = self.tx.get(Tables.Receipts.name, be64(tx_num))
        return T.decode_receipt(raw) if raw else None

    # -- plain state -----------------------------------------------------------

    def account(self, address: bytes) -> Account | None:
        raw = self.tx.get(Tables.PlainAccountState.name, address)
        return T.decode_account(raw) if raw else None

    def put_account(self, address: bytes, account: Account | None):
        if account is None:
            self.tx.delete(Tables.PlainAccountState.name, address)
        else:
            self.tx.put(Tables.PlainAccountState.name, address, T.encode_account(account))

    def _replace_dup(self, table: str, key: bytes, prefix: bytes, new_value: bytes | None):
        """Replace (or remove) the single duplicate of ``key`` starting with
        ``prefix`` — the one shared subkey-update primitive for all DUPSORT
        tables (storage state, hashed storage, storage trie)."""
        dup = self.tx.seek_dup(table, key, prefix)
        if dup is not None and dup[: len(prefix)] == prefix:
            self.tx.delete(table, key, dup)
        if new_value is not None:
            self.tx.put(table, key, new_value, dupsort=True)

    def _get_dup(self, table: str, key: bytes, prefix: bytes) -> bytes | None:
        dup = self.tx.seek_dup(table, key, prefix)
        if dup is not None and dup[: len(prefix)] == prefix:
            return dup
        return None

    def storage(self, address: bytes, slot: bytes) -> int:
        dup = self._get_dup(Tables.PlainStorageState.name, address, slot)
        return T.decode_storage_entry(dup)[1] if dup else 0

    def put_storage(self, address: bytes, slot: bytes, value: int):
        self._replace_dup(
            Tables.PlainStorageState.name, address, slot,
            T.encode_storage_entry(slot, value) if value else None,
        )

    def account_storage(self, address: bytes) -> dict[bytes, int]:
        out: dict[bytes, int] = {}
        cur = self.tx.cursor(Tables.PlainStorageState.name)
        for _, dup in cur.walk_dup(address):
            slot, value = T.decode_storage_entry(dup)
            out[slot] = value
        return out

    def clear_account_storage(self, address: bytes):
        self.tx.delete(Tables.PlainStorageState.name, address)

    def bytecode(self, code_hash: bytes) -> bytes | None:
        return self.tx.get(Tables.Bytecodes.name, code_hash)

    def put_bytecode(self, code_hash: bytes, code: bytes):
        self.tx.put(Tables.Bytecodes.name, code_hash, code)

    # -- changesets ------------------------------------------------------------

    def record_account_change(self, block: int, address: bytes, prev: Account | None):
        self.tx.put(
            Tables.AccountChangeSets.name, be64(block),
            T.encode_account_changeset(address, prev), dupsort=True,
        )

    def record_storage_change(self, block: int, address: bytes, slot: bytes, prev: int):
        self.tx.put(
            Tables.StorageChangeSets.name, be64(block) + address,
            T.encode_storage_entry(slot, prev), dupsort=True,
        )

    def account_changes_in_range(self, start: int, end: int) -> dict[bytes, Account | None]:
        """First-seen previous account per address in [start, end] (oldest wins)."""
        out: dict[bytes, Account | None] = {}
        cur = self.tx.cursor(Tables.AccountChangeSets.name)
        for key, dup in cur.walk_range(be64(start), be64(end + 1)):
            addr, prev = T.decode_account_changeset(dup)
            out.setdefault(addr, prev)
        return out

    def storage_changes_in_range(self, start: int, end: int) -> dict[bytes, dict[bytes, int]]:
        """First-seen previous value per (address, slot) in [start, end]."""
        out: dict[bytes, dict[bytes, int]] = {}
        cur = self.tx.cursor(Tables.StorageChangeSets.name)
        for key, dup in cur.walk_range(be64(start), be64(end + 1)):
            addr = key[8:28]
            slot, prev = T.decode_storage_entry(dup)
            out.setdefault(addr, {}).setdefault(slot, prev)
        return out

    def prune_changesets_above(self, block: int):
        """Drop changeset rows for blocks > ``block`` (unwind cleanup)."""
        cur = self.tx.cursor(Tables.AccountChangeSets.name)
        doomed = [k for k, _ in cur.walk(be64(block + 1))]
        for k in set(doomed):
            self.tx.delete(Tables.AccountChangeSets.name, k)
        cur = self.tx.cursor(Tables.StorageChangeSets.name)
        doomed = [k for k, _ in cur.walk(be64(block + 1))]
        for k in set(doomed):
            self.tx.delete(Tables.StorageChangeSets.name, k)

    def prune_receipts_above(self, block: int):
        idx = self.block_body_indices(block)
        if idx is None:
            return
        cur = self.tx.cursor(Tables.Receipts.name)
        doomed = [k for k, _ in cur.walk(be64(idx.next_tx_num))]
        for k in doomed:
            self.tx.delete(Tables.Receipts.name, k)

    # -- hashed state ----------------------------------------------------------

    def put_hashed_account(
        self, hashed_addr: bytes, account: Account | None,
        preserve_storage_root: bool = True,
    ):
        """Write a hashed-state account.

        The ``storage_root`` field of HashedAccounts entries is OWNED by the
        merkle layer (it keeps it current as storage tries change); writers
        of account state (hashing stage, tests) must not clobber it, so by
        default an existing entry's storage_root is carried over. The merkle
        layer passes ``preserve_storage_root=False`` when installing a
        freshly computed root.
        """
        if account is None:
            self.tx.delete(Tables.HashedAccounts.name, hashed_addr)
            return
        if preserve_storage_root:
            existing = self.hashed_account(hashed_addr)
            if existing is not None:
                account = account.with_(storage_root=existing.storage_root)
        self.tx.put(Tables.HashedAccounts.name, hashed_addr, T.encode_account(account))

    def hashed_account(self, hashed_addr: bytes) -> Account | None:
        raw = self.tx.get(Tables.HashedAccounts.name, hashed_addr)
        return T.decode_account(raw) if raw else None

    def clear_hashed_storage(self, hashed_addr: bytes):
        """Drop every hashed-storage entry of an account (selfdestruct wipe)."""
        self.tx.delete(Tables.HashedStorages.name, hashed_addr)

    def put_hashed_storage(self, hashed_addr: bytes, hashed_slot: bytes, value: int):
        self._replace_dup(
            Tables.HashedStorages.name, hashed_addr, hashed_slot,
            T.encode_storage_entry(hashed_slot, value) if value else None,
        )

    # -- trie ------------------------------------------------------------------

    def put_account_branch(self, path: bytes, node):
        self.tx.put(Tables.AccountsTrie.name, path, T.encode_branch_node(node))

    def account_branch(self, path: bytes):
        raw = self.tx.get(Tables.AccountsTrie.name, path)
        return T.decode_branch_node(raw) if raw else None

    def put_storage_branch(self, hashed_addr: bytes, path: bytes, node):
        # the 1-byte length prefix makes prefix-match == exact-path-match
        self._replace_dup(
            Tables.StoragesTrie.name, hashed_addr, bytes([len(path)]) + path,
            T.encode_storage_trie_entry(path, node),
        )

    def storage_branch(self, hashed_addr: bytes, path: bytes):
        dup = self._get_dup(
            Tables.StoragesTrie.name, hashed_addr, bytes([len(path)]) + path
        )
        return T.decode_storage_trie_entry(dup)[1] if dup else None

    def delete_account_branch(self, path: bytes):
        self.tx.delete(Tables.AccountsTrie.name, path)

    def delete_account_branches_with_prefix(self, prefix: bytes):
        cur = self.tx.cursor(Tables.AccountsTrie.name)
        doomed = []
        for k, _ in cur.walk(prefix):
            if k[: len(prefix)] != prefix:
                break  # keys are sorted: past the prefix range
            doomed.append(k)
        for k in doomed:
            self.tx.delete(Tables.AccountsTrie.name, k)

    def delete_storage_branch(self, hashed_addr: bytes, path: bytes):
        self._replace_dup(
            Tables.StoragesTrie.name, hashed_addr, bytes([len(path)]) + path, None
        )

    def delete_storage_branches_with_prefix(self, hashed_addr: bytes, prefix: bytes):
        cur = self.tx.cursor(Tables.StoragesTrie.name)
        doomed = []
        for _, dup in cur.walk_dup(hashed_addr):
            epath, _ = T.decode_storage_trie_entry(dup)
            if epath[: len(prefix)] == prefix:
                doomed.append(dup)
        for d in doomed:
            self.tx.delete(Tables.StoragesTrie.name, hashed_addr, d)

    def clear_trie_tables(self):
        self.tx.clear(Tables.AccountsTrie.name)
        self.tx.clear(Tables.StoragesTrie.name)

    # -- stage checkpoints ------------------------------------------------------

    def stage_checkpoint(self, stage: str) -> int:
        raw = self.tx.get(Tables.StageCheckpoints.name, stage.encode())
        return from_be64(raw[:8]) if raw else 0

    def save_stage_checkpoint(self, stage: str, block: int):
        self.tx.put(Tables.StageCheckpoints.name, stage.encode(), be64(block))

    def stage_progress(self, stage: str) -> bytes | None:
        return self.tx.get(Tables.StageCheckpointProgresses.name, stage.encode())

    def save_stage_progress(self, stage: str, blob: bytes | None):
        if blob is None:
            self.tx.delete(Tables.StageCheckpointProgresses.name, stage.encode())
        else:
            self.tx.put(Tables.StageCheckpointProgresses.name, stage.encode(), blob)


class ProviderFactory:
    """Creates transaction-scoped providers (reference `ProviderFactory`)."""

    def __init__(self, db: Database, static_files=None):
        if static_files is not None:
            raise NotImplementedError(_NO_STATIC_FILES)
        self.db = db
        self.static_files = None

    def provider(self) -> DatabaseProvider:
        return DatabaseProvider(self.db.tx())

    def provider_rw(self) -> DatabaseProvider:
        return DatabaseProvider(self.db.tx_mut())
