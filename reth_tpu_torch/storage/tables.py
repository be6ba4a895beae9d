"""Typed table schema — the database layout.

A copy of the JAX package's ``storage/tables.py`` (the reference's
`tables!` macro schema, ~31 tables,
crates/storage/db-api/src/tables/mod.rs:310-536). Keys/values are real
bytes (big-endian block numbers so integer order == byte order; raw
hashes/addresses), so the in-memory backend, ETL sorted loads, and the
future native backend all share one on-disk vocabulary.

DUPSORT tables follow the reference's (key, subkey‖value) model:
e.g. ``PlainStorageState``: key = address, duplicate = slot(32) ‖ value.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..primitives.rlp import rlp_encode, rlp_decode, encode_int, decode_int
from ..primitives.types import Account, Header, Log, Receipt, Transaction, encode_account


def be64(n: int) -> bytes:
    return n.to_bytes(8, "big")


def from_be64(b: bytes) -> int:
    return int.from_bytes(b, "big")


@dataclass(frozen=True)
class TableDef:
    name: str
    dupsort: bool = False


class Tables:
    """Table names (reference tables/mod.rs ordering, trimmed to parity)."""

    # block structure
    CanonicalHeaders = TableDef("CanonicalHeaders")          # be64(num) -> hash
    HeaderNumbers = TableDef("HeaderNumbers")                # hash -> be64(num)
    Headers = TableDef("Headers")                            # be64(num) -> rlp(header)
    BlockBodyIndices = TableDef("BlockBodyIndices")          # be64(num) -> be64(first_tx)||be64(count)
    BlockOmmers = TableDef("BlockOmmers")                    # be64(num) -> rlp([headers])
    BlockWithdrawals = TableDef("BlockWithdrawals")          # be64(num) -> rlp([withdrawals])
    Transactions = TableDef("Transactions")                  # be64(tx_num) -> tx encoding
    TransactionHashNumbers = TableDef("TransactionHashNumbers")  # tx_hash -> be64(tx_num)
    TransactionBlocks = TableDef("TransactionBlocks")        # be64(last_tx_num) -> be64(block)
    TransactionSenders = TableDef("TransactionSenders")      # be64(tx_num) -> address
    Receipts = TableDef("Receipts")                          # be64(tx_num) -> receipt encoding
    # plain state
    PlainAccountState = TableDef("PlainAccountState")        # address -> account encoding
    PlainStorageState = TableDef("PlainStorageState", dupsort=True)  # address -> slot||value32
    Bytecodes = TableDef("Bytecodes")                        # code_hash -> code
    # hashed state
    HashedAccounts = TableDef("HashedAccounts")              # keccak(addr) -> account encoding
    HashedStorages = TableDef("HashedStorages", dupsort=True)  # keccak(addr) -> keccak(slot)||value32
    # trie
    AccountsTrie = TableDef("AccountsTrie")                  # nibble path -> branch node
    StoragesTrie = TableDef("StoragesTrie", dupsort=True)    # keccak(addr) -> len||path||branch node
    # history / changesets
    AccountChangeSets = TableDef("AccountChangeSets", dupsort=True)  # be64(block) -> addr||prev_acct
    StorageChangeSets = TableDef("StorageChangeSets", dupsort=True)  # be64(block)||addr -> slot||prev
    AccountsHistory = TableDef("AccountsHistory")            # addr||be64(block) -> shard of block nums
    StoragesHistory = TableDef("StoragesHistory")            # addr||slot||be64(block) -> shard
    # meta
    StageCheckpoints = TableDef("StageCheckpoints")          # stage name -> checkpoint blob
    StageCheckpointProgresses = TableDef("StageCheckpointProgresses")  # stage -> progress blob
    PruneCheckpoints = TableDef("PruneCheckpoints")          # segment -> checkpoint
    Metadata = TableDef("Metadata")                          # arbitrary key -> value

    @classmethod
    def all(cls) -> list[TableDef]:
        return [v for v in vars(cls).values() if isinstance(v, TableDef)]


# ---------------------------------------------------------------------------
# value codecs (reference: Compact codec, db-api/src/models)
# ---------------------------------------------------------------------------


def decode_account(data: bytes) -> Account:
    nonce, balance, storage_root, code_hash = rlp_decode(data)
    return Account(decode_int(nonce), decode_int(balance), storage_root, code_hash)


def encode_header(h: Header) -> bytes:
    return h.encode()


def decode_header(data: bytes) -> Header:
    return Header.decode(data)


def encode_tx(tx: Transaction) -> bytes:
    return tx.encode()


def decode_tx(data: bytes) -> Transaction:
    return Transaction.decode(data)


def encode_receipt(r: Receipt) -> bytes:
    payload = rlp_encode([
        encode_int(r.tx_type),
        encode_int(1 if r.success else 0),
        encode_int(r.cumulative_gas_used),
        [log.rlp_fields() for log in r.logs],
    ])
    return payload


def decode_receipt(data: bytes) -> Receipt:
    tx_type, success, cum_gas, logs = rlp_decode(data)
    return Receipt(
        tx_type=decode_int(tx_type),
        success=bool(decode_int(success)),
        cumulative_gas_used=decode_int(cum_gas),
        logs=tuple(Log(a, tuple(t), d) for a, t, d in logs),
    )


def encode_storage_entry(slot: bytes, value: int) -> bytes:
    """DUPSORT storage entry: slot(32) ‖ value(32 BE)."""
    return slot + value.to_bytes(32, "big")


def decode_storage_entry(data: bytes) -> tuple[bytes, int]:
    return data[:32], int.from_bytes(data[32:64], "big")


def encode_account_changeset(addr: bytes, prev: Account | None) -> bytes:
    """DUPSORT changeset entry: address(20) ‖ optional previous account."""
    return addr + (encode_account(prev) if prev is not None else b"")


def decode_account_changeset(data: bytes) -> tuple[bytes, Account | None]:
    addr, rest = data[:20], data[20:]
    return addr, (decode_account(rest) if rest else None)


def encode_branch_node(node) -> bytes:
    """BranchNodeCompact: masks + child hashes (reference updates.rs)."""
    return rlp_encode([
        encode_int(node.state_mask),
        encode_int(node.tree_mask),
        encode_int(node.hash_mask),
        list(node.hashes),
    ])


def decode_branch_node(data: bytes):
    from ..trie.committer import BranchNode

    state_mask, tree_mask, hash_mask, hashes = rlp_decode(data)
    return BranchNode(
        decode_int(state_mask), decode_int(tree_mask), decode_int(hash_mask),
        tuple(hashes),
    )


def encode_storage_trie_entry(path: bytes, node) -> bytes:
    """DUPSORT StoragesTrie entry: len(path)(1) ‖ path ‖ branch node."""
    return bytes([len(path)]) + path + encode_branch_node(node)


def decode_storage_trie_entry(data: bytes):
    plen = data[0]
    return data[1 : 1 + plen], decode_branch_node(data[1 + plen :])
