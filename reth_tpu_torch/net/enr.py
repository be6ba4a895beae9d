"""ENR: Ethereum Node Records (EIP-778), "v4" identity scheme.

Reference analogue: the reference consumes ENRs through sigp/discv5 and
`enr` crates (crates/net/discv5/src/enr.rs converts discv5 ENRs into
`NodeRecord`s; crates/net/dns resolves ENR trees). A record is

  rlp([signature, seq, k1, v1, k2, v2, ...])   keys sorted, unique

signed over rlp([seq, k1, v1, ...]) with the node's secp256k1 key
("id" = "v4" scheme). The discv5 node id is keccak256(uncompressed
64-byte pubkey).
"""

from __future__ import annotations

import base64
import ipaddress

from ..primitives import secp256k1
from ..primitives.keccak import keccak256
from ..primitives.rlp import decode_int, encode_int, rlp_decode_prefix, rlp_encode
from ..primitives.secp256k1 import (
    compress_pubkey,
    decompress_pubkey,
    pubkey_from_priv,
    pubkey_to_bytes,
)

MAX_ENR_SIZE = 300


class EnrError(ValueError):
    pass


def node_id_from_pubkey(pub: tuple[int, int]) -> bytes:
    """discv5 node id: keccak256 of the raw 64-byte public key."""
    return keccak256(pubkey_to_bytes(pub))


class Enr:
    """One node record. ``pairs`` holds raw value bytes keyed by str."""

    def __init__(self, seq: int, pairs: dict[str, bytes], signature: bytes = b""):
        self.seq = seq
        self.pairs = dict(pairs)
        self.signature = signature

    # -- typed accessors ---------------------------------------------------
    @property
    def pubkey(self) -> tuple[int, int]:
        raw = self.pairs.get("secp256k1")
        if raw is None:
            raise EnrError("record has no secp256k1 key")
        return decompress_pubkey(raw)

    @property
    def node_id(self) -> bytes:
        return node_id_from_pubkey(self.pubkey)

    @property
    def ip(self) -> str | None:
        raw = self.pairs.get("ip")
        return str(ipaddress.ip_address(raw)) if raw else None

    def _port(self, key: str) -> int | None:
        raw = self.pairs.get(key)
        return decode_int(raw) if raw else None

    @property
    def udp_port(self) -> int | None:
        return self._port("udp")

    @property
    def tcp_port(self) -> int | None:
        return self._port("tcp")

    # -- codec -------------------------------------------------------------
    def _content(self) -> list:
        items: list = [encode_int(self.seq)]
        for k in sorted(self.pairs):
            items += [k.encode(), self.pairs[k]]
        return items

    def encode(self) -> bytes:
        raw = rlp_encode([self.signature] + self._content())
        if len(raw) > MAX_ENR_SIZE:
            raise EnrError("record exceeds 300 bytes")
        return raw

    @classmethod
    def decode(cls, raw: bytes) -> "Enr":
        if len(raw) > MAX_ENR_SIZE:
            raise EnrError("record exceeds 300 bytes")
        fields, consumed = rlp_decode_prefix(raw)
        if (consumed != len(raw) or not isinstance(fields, list)
                or len(fields) < 2 or len(fields) % 2):
            raise EnrError("malformed record")
        sig = bytes(fields[0])
        seq = decode_int(fields[1])
        pairs: dict[str, bytes] = {}
        last = None
        for i in range(2, len(fields), 2):
            k = bytes(fields[i]).decode("ascii", "strict")
            if last is not None and k <= last:
                raise EnrError("keys not sorted/unique")
            last = k
            pairs[k] = bytes(fields[i + 1])
        rec = cls(seq, pairs, sig)
        rec.verify()
        return rec

    # -- v4 identity scheme -------------------------------------------------
    def sign(self, priv: int) -> "Enr":
        self.pairs["id"] = b"v4"
        self.pairs["secp256k1"] = compress_pubkey(pubkey_from_priv(priv))
        digest = keccak256(rlp_encode(self._content()))
        _y, r, s = secp256k1.sign(digest, priv)
        self.signature = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        return self

    def verify(self) -> None:
        if self.pairs.get("id") != b"v4":
            raise EnrError("unsupported identity scheme")
        if len(self.signature) != 64:
            raise EnrError("bad signature length")
        digest = keccak256(rlp_encode(self._content()))
        r = int.from_bytes(self.signature[:32], "big")
        s = int.from_bytes(self.signature[32:], "big")
        pub = self.pubkey
        # non-malleable 64-byte sig: try both recovery bits
        for y in (0, 1):
            try:
                if secp256k1.ecrecover(digest, y, r, s, allow_high_s=True,
                                       return_pubkey=True) == pubkey_to_bytes(pub):
                    return
            except Exception:  # noqa: BLE001 — invalid curve point for this bit
                continue
        raise EnrError("signature does not match secp256k1 key")

    # -- text form -----------------------------------------------------------
    def to_base64(self) -> str:
        return "enr:" + base64.urlsafe_b64encode(self.encode()).rstrip(b"=").decode()

    @classmethod
    def from_base64(cls, text: str) -> "Enr":
        if not text.startswith("enr:"):
            raise EnrError("missing enr: prefix")
        b64 = text[4:]
        raw = base64.urlsafe_b64decode(b64 + "=" * (-len(b64) % 4))
        return cls.decode(raw)


def make_enr(priv: int, ip: str | None = None, udp: int | None = None,
             tcp: int | None = None, seq: int = 1, **extra: bytes) -> Enr:
    pairs: dict[str, bytes] = {}
    if ip is not None:
        pairs["ip"] = ipaddress.ip_address(ip).packed
    if udp is not None:
        pairs["udp"] = encode_int(udp)
    if tcp is not None:
        pairs["tcp"] = encode_int(tcp)
    pairs.update(extra)
    return Enr(seq, pairs).sign(priv)
