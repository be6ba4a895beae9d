"""Core chain types: Account, Header, Transaction, Receipt, Block.

A copy of the JAX package's ``primitives/types.py`` (alloy-consensus types +
`EthPrimitives`; encodings follow Ethereum consensus RLP, post-merge through
Cancun/Prague, trailing-optional header fields included only when set), plus
``encode_account``, the state tables' account encoding. Signature recovery
(``Authorization.recover_authority``, ``Transaction.recover_sender``,
``recover_senders``) needs secp256k1 and is not ported yet: it raises
``NotImplementedError`` (ROADMAP A item 7, the EVM).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .keccak import keccak256
from .rlp import rlp_encode, rlp_decode, encode_int, decode_int

# keccak256(rlp(b"")) — root of the empty trie.
EMPTY_ROOT_HASH = keccak256(rlp_encode(b""))
# keccak256(b"") — code hash of an EOA / empty code.
KECCAK_EMPTY = keccak256(b"")
EMPTY_CODE_HASH = KECCAK_EMPTY
# keccak256(rlp([])) — ommers hash of an empty ommer list.
EMPTY_OMMER_ROOT_HASH = keccak256(rlp_encode([]))

B256_ZERO = b"\x00" * 32
ADDRESS_ZERO = b"\x00" * 20

_RECOVERY = "signature recovery (secp256k1) is not ported yet (ROADMAP A item 7)"


@dataclass(frozen=True)
class Account:
    """An Ethereum account (reference: alloy `TrieAccount` / reth `Account`)."""

    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_ROOT_HASH
    code_hash: bytes = KECCAK_EMPTY

    def trie_encode(self) -> bytes:
        """RLP leaf value as stored in the state trie."""
        return rlp_encode([
            encode_int(self.nonce),
            encode_int(self.balance),
            self.storage_root,
            self.code_hash,
        ])

    @classmethod
    def trie_decode(cls, data: bytes) -> "Account":
        nonce, balance, storage_root, code_hash = rlp_decode(data)
        return cls(decode_int(nonce), decode_int(balance), storage_root, code_hash)

    @property
    def is_empty(self) -> bool:
        """EIP-161 emptiness: nonce==0, balance==0, no code."""
        return self.nonce == 0 and self.balance == 0 and self.code_hash == KECCAK_EMPTY

    def with_(self, **kw) -> "Account":
        return replace(self, **kw)


def encode_account(acc: Account) -> bytes:
    """Compact account encoding for plain/hashed state tables."""
    return rlp_encode([
        encode_int(acc.nonce),
        encode_int(acc.balance),
        acc.storage_root,
        acc.code_hash,
    ])


@dataclass(frozen=True)
class Withdrawal:
    index: int
    validator_index: int
    address: bytes
    amount: int  # gwei

    def rlp_fields(self) -> list:
        return [
            encode_int(self.index),
            encode_int(self.validator_index),
            self.address,
            encode_int(self.amount),
        ]


@dataclass(frozen=True)
class Header:
    """Block header (reference: alloy-consensus `Header`)."""

    parent_hash: bytes = B256_ZERO
    ommers_hash: bytes = EMPTY_OMMER_ROOT_HASH
    beneficiary: bytes = ADDRESS_ZERO
    state_root: bytes = EMPTY_ROOT_HASH
    transactions_root: bytes = EMPTY_ROOT_HASH
    receipts_root: bytes = EMPTY_ROOT_HASH
    logs_bloom: bytes = b"\x00" * 256
    difficulty: int = 0
    number: int = 0
    gas_limit: int = 30_000_000
    gas_used: int = 0
    timestamp: int = 0
    extra_data: bytes = b""
    mix_hash: bytes = B256_ZERO
    nonce: bytes = b"\x00" * 8
    base_fee_per_gas: int | None = None
    withdrawals_root: bytes | None = None
    blob_gas_used: int | None = None
    excess_blob_gas: int | None = None
    parent_beacon_block_root: bytes | None = None
    requests_hash: bytes | None = None

    def rlp_fields(self) -> list:
        fields: list = [
            self.parent_hash,
            self.ommers_hash,
            self.beneficiary,
            self.state_root,
            self.transactions_root,
            self.receipts_root,
            self.logs_bloom,
            encode_int(self.difficulty),
            encode_int(self.number),
            encode_int(self.gas_limit),
            encode_int(self.gas_used),
            encode_int(self.timestamp),
            self.extra_data,
            self.mix_hash,
            self.nonce,
        ]
        # Trailing optionals: include a field iff it or any later field is set.
        opts = [
            None if self.base_fee_per_gas is None else encode_int(self.base_fee_per_gas),
            self.withdrawals_root,
            None if self.blob_gas_used is None else encode_int(self.blob_gas_used),
            None if self.excess_blob_gas is None else encode_int(self.excess_blob_gas),
            self.parent_beacon_block_root,
            self.requests_hash,
        ]
        last_set = -1
        for i, v in enumerate(opts):
            if v is not None:
                last_set = i
        for i in range(last_set + 1):
            v = opts[i]
            if v is None:
                raise ValueError("non-contiguous optional header fields")
            fields.append(v)
        return fields

    def encode(self) -> bytes:
        return rlp_encode(self.rlp_fields())

    @classmethod
    def decode_fields(cls, f: list) -> "Header":
        h = cls(
            parent_hash=f[0], ommers_hash=f[1], beneficiary=f[2], state_root=f[3],
            transactions_root=f[4], receipts_root=f[5], logs_bloom=f[6],
            difficulty=decode_int(f[7]), number=decode_int(f[8]),
            gas_limit=decode_int(f[9]), gas_used=decode_int(f[10]),
            timestamp=decode_int(f[11]), extra_data=f[12], mix_hash=f[13], nonce=f[14],
        )
        extra = f[15:]
        kw: dict = {}
        if len(extra) > 0:
            kw["base_fee_per_gas"] = decode_int(extra[0])
        if len(extra) > 1:
            kw["withdrawals_root"] = extra[1]
        if len(extra) > 2:
            kw["blob_gas_used"] = decode_int(extra[2])
        if len(extra) > 3:
            kw["excess_blob_gas"] = decode_int(extra[3])
        if len(extra) > 4:
            kw["parent_beacon_block_root"] = extra[4]
        if len(extra) > 5:
            kw["requests_hash"] = extra[5]
        return replace(h, **kw)

    @classmethod
    def decode(cls, data: bytes) -> "Header":
        return cls.decode_fields(rlp_decode(data))

    @property
    def hash(self) -> bytes:
        return keccak256(self.encode())


LEGACY_TX_TYPE = 0
EIP2930_TX_TYPE = 1
EIP1559_TX_TYPE = 2
EIP4844_TX_TYPE = 3
EIP7702_TX_TYPE = 4

SETCODE_MAGIC = b"\x05"              # EIP-7702 authorization signing domain
DELEGATION_PREFIX = b"\xef\x01\x00"  # EIP-7702 delegation designator


@dataclass(frozen=True)
class Authorization:
    """EIP-7702 set-code authorization tuple (signed by the authority)."""

    chain_id: int
    address: bytes
    nonce: int
    y_parity: int = 0
    r: int = 0
    s: int = 0

    def signing_hash(self) -> bytes:
        return keccak256(SETCODE_MAGIC + rlp_encode([
            encode_int(self.chain_id), self.address, encode_int(self.nonce),
        ]))

    def recover_authority(self) -> bytes:
        raise NotImplementedError(_RECOVERY)

    def rlp_fields(self) -> list:
        return [encode_int(self.chain_id), self.address, encode_int(self.nonce),
                encode_int(self.y_parity), encode_int(self.r), encode_int(self.s)]

    @classmethod
    def from_fields(cls, f) -> "Authorization":
        if len(f[1]) != 20:
            raise ValueError("authorization address must be 20 bytes")
        return cls(chain_id=decode_int(f[0]), address=f[1], nonce=decode_int(f[2]),
                   y_parity=decode_int(f[3]), r=decode_int(f[4]), s=decode_int(f[5]))


@dataclass(frozen=True)
class Transaction:
    """Signed transaction envelope: legacy (0), EIP-2930 (1), EIP-1559 (2),
    EIP-4844 blob (3), EIP-7702 set-code (4).

    Reference: alloy-consensus `TxEnvelope`; reth recovers senders in
    `SenderRecoveryStage` (crates/stages/stages/src/stages/sender_recovery.rs).
    """

    tx_type: int = LEGACY_TX_TYPE
    chain_id: int | None = None
    nonce: int = 0
    gas_price: int = 0                # legacy/2930; for 1559+ use max_fee fields
    max_priority_fee_per_gas: int = 0
    max_fee_per_gas: int = 0
    gas_limit: int = 21_000
    to: bytes | None = None           # None = contract creation
    value: int = 0
    data: bytes = b""
    access_list: tuple = ()            # ((address, (slot32, ...)), ...)
    max_fee_per_blob_gas: int = 0      # type 3
    blob_versioned_hashes: tuple = ()  # type 3
    authorization_list: tuple = ()     # type 4: (Authorization, ...)
    # signature
    y_parity: int = 0
    r: int = 0
    s: int = 0

    def _to_field(self) -> bytes:
        return self.to if self.to is not None else b""

    def _access_list_fields(self) -> list:
        return [[addr, list(slots)] for addr, slots in self.access_list]

    def _auth_fields(self) -> list:
        return [a.rlp_fields() for a in self.authorization_list]

    def _typed_payload_fields(self) -> list:
        """Unsigned field list for typed txs (1/2/3/4)."""
        if self.tx_type == EIP2930_TX_TYPE:
            return [
                encode_int(self.chain_id or 0), encode_int(self.nonce),
                encode_int(self.gas_price), encode_int(self.gas_limit),
                self._to_field(), encode_int(self.value), self.data,
                self._access_list_fields(),
            ]
        fields = [
            encode_int(self.chain_id or 0), encode_int(self.nonce),
            encode_int(self.max_priority_fee_per_gas), encode_int(self.max_fee_per_gas),
            encode_int(self.gas_limit), self._to_field(),
            encode_int(self.value), self.data, self._access_list_fields(),
        ]
        if self.tx_type == EIP4844_TX_TYPE:
            fields += [encode_int(self.max_fee_per_blob_gas),
                       list(self.blob_versioned_hashes)]
        elif self.tx_type == EIP7702_TX_TYPE:
            fields += [self._auth_fields()]
        return fields

    def signing_hash(self) -> bytes:
        if self.tx_type == LEGACY_TX_TYPE:
            fields = [
                encode_int(self.nonce), encode_int(self.gas_price),
                encode_int(self.gas_limit), self._to_field(),
                encode_int(self.value), self.data,
            ]
            if self.chain_id is not None:  # EIP-155
                fields += [encode_int(self.chain_id), b"", b""]
            return keccak256(rlp_encode(fields))
        if self.tx_type in (EIP2930_TX_TYPE, EIP1559_TX_TYPE, EIP4844_TX_TYPE,
                            EIP7702_TX_TYPE):
            return keccak256(bytes([self.tx_type])
                             + rlp_encode(self._typed_payload_fields()))
        raise ValueError(f"unsupported tx type {self.tx_type}")

    def encode(self) -> bytes:
        """Network/consensus encoding (typed txs prefixed with their type byte)."""
        if self.tx_type == LEGACY_TX_TYPE:
            if self.chain_id is not None:
                v = self.chain_id * 2 + 35 + self.y_parity
            else:
                v = 27 + self.y_parity
            return rlp_encode([
                encode_int(self.nonce), encode_int(self.gas_price),
                encode_int(self.gas_limit), self._to_field(),
                encode_int(self.value), self.data,
                encode_int(v), encode_int(self.r), encode_int(self.s),
            ])
        if self.tx_type in (EIP2930_TX_TYPE, EIP1559_TX_TYPE, EIP4844_TX_TYPE,
                            EIP7702_TX_TYPE):
            fields = self._typed_payload_fields() + [
                encode_int(self.y_parity), encode_int(self.r), encode_int(self.s),
            ]
            return bytes([self.tx_type]) + rlp_encode(fields)
        raise ValueError(f"unsupported tx type {self.tx_type}")

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        data = bytes(data)
        if data and data[0] == EIP2930_TX_TYPE:
            f = rlp_decode(data[1:])
            return cls(
                tx_type=EIP2930_TX_TYPE, chain_id=decode_int(f[0]),
                nonce=decode_int(f[1]), gas_price=decode_int(f[2]),
                gas_limit=decode_int(f[3]), to=f[4] or None,
                value=decode_int(f[5]), data=f[6],
                access_list=tuple((a, tuple(slots)) for a, slots in f[7]),
                y_parity=decode_int(f[8]), r=decode_int(f[9]), s=decode_int(f[10]),
            )
        if data and data[0] in (EIP1559_TX_TYPE, EIP4844_TX_TYPE, EIP7702_TX_TYPE):
            tx_type = data[0]
            f = rlp_decode(data[1:])
            kw = dict(
                tx_type=tx_type, chain_id=decode_int(f[0]),
                nonce=decode_int(f[1]), max_priority_fee_per_gas=decode_int(f[2]),
                max_fee_per_gas=decode_int(f[3]), gas_limit=decode_int(f[4]),
                to=f[5] or None, value=decode_int(f[6]), data=f[7],
                access_list=tuple((a, tuple(slots)) for a, slots in f[8]),
            )
            i = 9
            if tx_type == EIP4844_TX_TYPE:
                kw["max_fee_per_blob_gas"] = decode_int(f[9])
                hashes = tuple(f[10])
                if any(len(h) != 32 for h in hashes):
                    raise ValueError("blob versioned hash must be 32 bytes")
                kw["blob_versioned_hashes"] = hashes
                i = 11
            elif tx_type == EIP7702_TX_TYPE:
                kw["authorization_list"] = tuple(
                    Authorization.from_fields(a) for a in f[9]
                )
                i = 10
            return cls(
                y_parity=decode_int(f[i]), r=decode_int(f[i + 1]),
                s=decode_int(f[i + 2]), **kw,
            )
        f = rlp_decode(data)
        v = decode_int(f[6])
        if v in (27, 28):
            chain_id, y_parity = None, v - 27
        elif v >= 35:
            chain_id = (v - 35) // 2
            y_parity = (v - 35) % 2
        else:
            raise ValueError(f"invalid legacy signature v: {v}")
        return cls(
            tx_type=LEGACY_TX_TYPE, chain_id=chain_id, nonce=decode_int(f[0]),
            gas_price=decode_int(f[1]), gas_limit=decode_int(f[2]), to=f[3] or None,
            value=decode_int(f[4]), data=f[5], y_parity=y_parity,
            r=decode_int(f[7]), s=decode_int(f[8]),
        )

    @property
    def hash(self) -> bytes:
        return keccak256(self.encode())

    def effective_gas_price(self, base_fee: int | None) -> int:
        if self.tx_type in (LEGACY_TX_TYPE, EIP2930_TX_TYPE):
            return self.gas_price
        if base_fee is None:
            return self.max_fee_per_gas
        return min(self.max_fee_per_gas, base_fee + self.max_priority_fee_per_gas)

    def blob_gas(self) -> int:
        return GAS_PER_BLOB * len(self.blob_versioned_hashes)

    def recover_sender(self) -> bytes:
        raise NotImplementedError(_RECOVERY)


GAS_PER_BLOB = 1 << 17  # EIP-4844


def recover_senders(txs, allow_high_s: bool = False) -> list[bytes | None]:
    """Batched sender recovery for a transaction sequence: not ported yet."""
    raise NotImplementedError(_RECOVERY)


@dataclass(frozen=True)
class Log:
    address: bytes
    topics: tuple[bytes, ...]
    data: bytes

    def rlp_fields(self) -> list:
        return [self.address, list(self.topics), self.data]


def logs_bloom(logs: list[Log]) -> bytes:
    """2048-bit bloom over log addresses and topics (yellow paper M3:2048)."""
    bloom = bytearray(256)
    items: list[bytes] = []
    for log in logs:
        items.append(log.address)
        items.extend(log.topics)
    for item in items:
        h = keccak256(item)
        for i in (0, 2, 4):
            bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
            bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


@dataclass(frozen=True)
class Receipt:
    """Transaction receipt (reference: reth `Receipt`).

    ``state_root`` is the pre-Byzantium form: receipts embedded the
    post-transaction state root until EIP-658 replaced it with the
    success status."""

    tx_type: int = LEGACY_TX_TYPE
    success: bool = True
    cumulative_gas_used: int = 0
    logs: tuple[Log, ...] = ()
    state_root: bytes | None = None

    def bloom(self) -> bytes:
        return logs_bloom(list(self.logs))

    def encode_2718(self) -> bytes:
        """EIP-2718 encoding as placed in the receipts trie."""
        payload = rlp_encode([
            (self.state_root if self.state_root is not None
             else encode_int(1 if self.success else 0)),
            encode_int(self.cumulative_gas_used),
            self.bloom(),
            [log.rlp_fields() for log in self.logs],
        ])
        if self.tx_type == LEGACY_TX_TYPE:
            return payload
        return bytes([self.tx_type]) + payload


def body_rlp_fields(
    transactions: tuple[Transaction, ...],
    ommers: tuple[Header, ...],
    withdrawals: tuple[Withdrawal, ...] | None,
) -> list:
    """Block-body RLP shape — the single home for it (blocks + wire bodies)."""
    fields: list = [
        [_tx_block_item(tx) for tx in transactions],
        [o.rlp_fields() for o in ommers],
    ]
    if withdrawals is not None:
        fields.append([w.rlp_fields() for w in withdrawals])
    return fields


def body_from_fields(f: list):
    """Inverse of ``body_rlp_fields`` → (txs, ommers, withdrawals)."""
    withdrawals = None
    if len(f) > 2:
        withdrawals = tuple(
            Withdrawal(decode_int(w[0]), decode_int(w[1]), w[2], decode_int(w[3]))
            for w in f[2]
        )
    return (
        tuple(_tx_from_block_item(t) for t in f[0]),
        tuple(Header.decode_fields(o) for o in f[1]),
        withdrawals,
    )


@dataclass(frozen=True)
class Block:
    header: Header
    transactions: tuple[Transaction, ...] = ()
    ommers: tuple[Header, ...] = ()
    withdrawals: tuple[Withdrawal, ...] | None = None

    def encode(self) -> bytes:
        return rlp_encode(
            [self.header.rlp_fields()]
            + body_rlp_fields(self.transactions, self.ommers, self.withdrawals)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        f = rlp_decode(data)
        header = Header.decode_fields(f[0])
        txs, ommers, withdrawals = body_from_fields(f[1:])
        return cls(header, txs, ommers, withdrawals)

    @property
    def hash(self) -> bytes:
        return self.header.hash


def _tx_block_item(tx: Transaction):
    """In a block body, typed txs appear as RLP strings, legacy as lists."""
    enc = tx.encode()
    if tx.tx_type == LEGACY_TX_TYPE:
        return rlp_decode(enc)  # as a list structure
    return enc


def _tx_from_block_item(item) -> Transaction:
    if isinstance(item, bytes):
        return Transaction.decode(item)
    return Transaction.decode(rlp_encode(item))
