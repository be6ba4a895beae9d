"""eth wire protocol messages (eth/68 vocabulary) + frame codec.

Reference analogue: crates/net/eth-wire-types — the `EthMessage` enum
(src/message.rs:312, ids :624) and per-message RLP shapes. Frames are
``u32 length | u8 msg_id | rlp payload`` (the RLPx snappy/AES layers are
a later milestone).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..primitives.rlp import decode_int, encode_int, rlp_decode, rlp_encode
from ..primitives.types import Block, Header, Receipt, Transaction, Withdrawal


class MessageId:
    STATUS = 0x00
    NEW_BLOCK_HASHES = 0x01
    TRANSACTIONS = 0x02
    GET_BLOCK_HEADERS = 0x03
    BLOCK_HEADERS = 0x04
    GET_BLOCK_BODIES = 0x05
    BLOCK_BODIES = 0x06
    NEW_BLOCK = 0x07
    NEW_POOLED_TX_HASHES = 0x08
    GET_POOLED_TRANSACTIONS = 0x09
    POOLED_TRANSACTIONS = 0x0A
    GET_RECEIPTS = 0x0F
    RECEIPTS = 0x10
    BLOCK_RANGE_UPDATE = 0x11  # eth/69


@dataclass
class Status:
    """eth status handshake. eth/68 carries total difficulty + head hash;
    eth/69 replaces TD with the served block range (earliest, latest,
    latest hash) — `version` selects the wire shape."""

    version: int = 68
    network_id: int = 1
    total_difficulty: int = 0
    head: bytes = b"\x00" * 32
    genesis: bytes = b"\x00" * 32
    fork_id: tuple[bytes, int] = (b"\x00" * 4, 0)
    earliest: int = 0  # eth/69: first block this node can serve
    latest: int = 0    # eth/69: tip number (head keeps the tip hash)

    def encode_payload(self):
        fid = [self.fork_id[0], encode_int(self.fork_id[1])]
        if self.version >= 69:
            return [
                encode_int(self.version), encode_int(self.network_id),
                self.genesis, fid, encode_int(self.earliest),
                encode_int(self.latest), self.head,
            ]
        return [
            encode_int(self.version), encode_int(self.network_id),
            encode_int(self.total_difficulty), self.head, self.genesis, fid,
        ]

    @classmethod
    def decode_payload(cls, f):
        version = decode_int(f[0])
        if version >= 69:
            return cls(
                version, decode_int(f[1]), 0, bytes(f[6]), bytes(f[2]),
                (bytes(f[3][0]), decode_int(f[3][1])),
                decode_int(f[4]), decode_int(f[5]),
            )
        return cls(
            version, decode_int(f[1]), decode_int(f[2]), f[3], f[4],
            (f[5][0], decode_int(f[5][1])),
        )


@dataclass
class BlockRangeUpdate:
    """eth/69: the served block range changed (replaces TD gossip)."""

    earliest: int
    latest: int
    latest_hash: bytes

    def encode_payload(self):
        return [encode_int(self.earliest), encode_int(self.latest),
                self.latest_hash]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), decode_int(f[1]), bytes(f[2]))


@dataclass
class GetBlockHeaders:
    request_id: int
    start: int | bytes     # number or hash
    limit: int
    skip: int = 0
    reverse: bool = False

    def encode_payload(self):
        start = self.start if isinstance(self.start, bytes) and len(self.start) == 32 \
            else encode_int(self.start)
        return [encode_int(self.request_id),
                [start, encode_int(self.limit), encode_int(self.skip),
                 encode_int(1 if self.reverse else 0)]]

    @classmethod
    def decode_payload(cls, f):
        rid, (start, limit, skip, rev) = decode_int(f[0]), f[1]
        s = start if len(start) == 32 else decode_int(start)
        return cls(rid, s, decode_int(limit), decode_int(skip), bool(decode_int(rev)))


@dataclass
class BlockHeaders:
    request_id: int
    headers: list[Header]

    def encode_payload(self):
        return [encode_int(self.request_id), [h.rlp_fields() for h in self.headers]]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [Header.decode_fields(h) for h in f[1]])


@dataclass
class GetBlockBodies:
    request_id: int
    hashes: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.hashes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), list(f[1]))


@dataclass
class BlockBody:
    transactions: tuple[Transaction, ...] = ()
    ommers: tuple[Header, ...] = ()
    withdrawals: tuple[Withdrawal, ...] | None = None

    def rlp_fields(self):
        from ..primitives.types import body_rlp_fields

        return body_rlp_fields(self.transactions, self.ommers, self.withdrawals)

    @classmethod
    def decode_fields(cls, f):
        from ..primitives.types import body_from_fields

        return cls(*body_from_fields(f))


@dataclass
class BlockBodies:
    request_id: int
    bodies: list[BlockBody]

    def encode_payload(self):
        return [encode_int(self.request_id), [b.rlp_fields() for b in self.bodies]]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [BlockBody.decode_fields(b) for b in f[1]])


@dataclass
class GetReceipts:
    request_id: int
    hashes: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.hashes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), list(f[1]))


@dataclass
class ReceiptsMsg:
    request_id: int
    receipts: list[list[bytes]]  # per block: encoded receipts

    def encode_payload(self):
        return [encode_int(self.request_id), [list(rs) for rs in self.receipts]]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), [list(rs) for rs in f[1]])


@dataclass
class TransactionsMsg:
    transactions: list[Transaction]

    def encode_payload(self):
        from ..primitives.types import _tx_block_item

        return [_tx_block_item(tx) for tx in self.transactions]

    @classmethod
    def decode_payload(cls, f):
        from ..primitives.types import _tx_from_block_item

        return cls([_tx_from_block_item(t) for t in f])


@dataclass
class NewPooledTxHashes:
    """eth/68 announcement: types + sizes + hashes."""

    types: bytes
    sizes: list[int]
    hashes: list[bytes]

    def encode_payload(self):
        return [self.types, [encode_int(s) for s in self.sizes], list(self.hashes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(f[0], [decode_int(s) for s in f[1]], list(f[2]))


@dataclass
class GetPooledTransactions:
    request_id: int
    hashes: list[bytes]

    def encode_payload(self):
        return [encode_int(self.request_id), list(self.hashes)]

    @classmethod
    def decode_payload(cls, f):
        return cls(decode_int(f[0]), list(f[1]))


@dataclass
class PooledTransactions:
    request_id: int
    transactions: list[Transaction]

    def encode_payload(self):
        from ..primitives.types import _tx_block_item

        return [encode_int(self.request_id),
                [_tx_block_item(tx) for tx in self.transactions]]

    @classmethod
    def decode_payload(cls, f):
        from ..primitives.types import _tx_from_block_item

        return cls(decode_int(f[0]), [_tx_from_block_item(t) for t in f[1]])


@dataclass
class NewBlockHashes:
    entries: list[tuple[bytes, int]]  # (hash, number)

    def encode_payload(self):
        return [[h, encode_int(n)] for h, n in self.entries]

    @classmethod
    def decode_payload(cls, f):
        return cls([(e[0], decode_int(e[1])) for e in f])


EthMessage = (
    Status | GetBlockHeaders | BlockHeaders | GetBlockBodies | BlockBodies
    | GetReceipts | ReceiptsMsg | TransactionsMsg | NewPooledTxHashes
    | GetPooledTransactions | PooledTransactions | NewBlockHashes
)

_BY_ID = {
    MessageId.STATUS: Status,
    MessageId.NEW_BLOCK_HASHES: NewBlockHashes,
    MessageId.TRANSACTIONS: TransactionsMsg,
    MessageId.GET_BLOCK_HEADERS: GetBlockHeaders,
    MessageId.BLOCK_HEADERS: BlockHeaders,
    MessageId.GET_BLOCK_BODIES: GetBlockBodies,
    MessageId.BLOCK_BODIES: BlockBodies,
    MessageId.NEW_POOLED_TX_HASHES: NewPooledTxHashes,
    MessageId.GET_POOLED_TRANSACTIONS: GetPooledTransactions,
    MessageId.POOLED_TRANSACTIONS: PooledTransactions,
    MessageId.GET_RECEIPTS: GetReceipts,
    MessageId.RECEIPTS: ReceiptsMsg,
    MessageId.BLOCK_RANGE_UPDATE: BlockRangeUpdate,
}
_TO_ID = {v: k for k, v in _BY_ID.items()}


def encode_message(msg) -> bytes:
    payload = rlp_encode(msg.encode_payload())
    mid = _TO_ID[type(msg)]
    return struct.pack("<IB", len(payload) + 1, mid) + payload


def decode_message(frame: bytes):
    mid = frame[0]
    cls = _BY_ID.get(mid)
    if cls is None:
        raise ValueError(f"unknown message id {mid:#x}")
    return cls.decode_payload(rlp_decode(frame[1:]))


def encode_eth(msg) -> tuple[int, bytes]:
    """(eth/68 message id, RLP payload) — the RLPx capability framing
    (net/rlpx.py adds the base-protocol offset and snappy)."""
    return _TO_ID[type(msg)], rlp_encode(msg.encode_payload())


def decode_eth(mid: int, payload: bytes):
    cls = _BY_ID.get(mid)
    if cls is None:
        raise ValueError(f"unknown eth message id {mid:#x}")
    return cls.decode_payload(rlp_decode(payload))
