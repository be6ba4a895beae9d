"""discv5 (v5.1): encrypted UDP node discovery with ENRs.

Reference analogue: crates/net/discv5 (the reference wraps sigp/discv5;
src/lib.rs builds the service, src/enr.rs converts records). This is a
from-scratch implementation of the wire protocol:

  packet = masking-iv(16) || AES-CTR(dest-id[:16], iv)(header) || message
  header = "discv5" || 0x0001 || flag(1) || nonce(12) || authdata-len(2)
           || authdata

Flags: 0 ordinary (authdata = src-id; message AES-GCM encrypted under the
session key, AD = masking-iv || header), 1 WHOAREYOU (authdata = id-nonce
(16) || enr-seq(8)), 2 handshake (authdata = src-id || sig-size ||
eph-key-size || id-signature || eph-pubkey || optional ENR).

Session keys (HKDF-SHA256): ikm = compressed ECDH point, salt =
challenge-data (= masking-iv || whoareyou header), info =
"discovery v5 key agreement" || src-id || dest-id -> initiator-key(16)
|| recipient-key(16). The id-signature covers sha256("discovery v5
identity proof" || challenge-data || eph-pubkey || dest-id).

Messages: PING [rid, enr-seq], PONG [rid, enr-seq, ip, port],
FINDNODE [rid, [log2-distance...]], NODES [rid, total, [ENR...]].
Kademlia distance is xor over the 32-byte node ids directly (ids are
already keccak outputs).
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import threading
import time

from ..primitives import secp256k1
from ..primitives.rlp import decode_int, encode_int, rlp_decode_prefix, rlp_encode
from ..primitives.secp256k1 import (
    compress_pubkey,
    pubkey_from_priv,
    random_priv,
)
from ._aes import AESGCM, Cipher, algorithms, modes  # the port's AES, csrc/aes.cpp
from .enr import Enr, make_enr, node_id_from_pubkey

PROTOCOL_ID = b"discv5"
VERSION = b"\x00\x01"
FLAG_ORDINARY, FLAG_WHOAREYOU, FLAG_HANDSHAKE = 0, 1, 2

PING, PONG, FINDNODE, NODES = 0x01, 0x02, 0x03, 0x04

ID_SIGNATURE_TEXT = b"discovery v5 identity proof"
KDF_INFO_TEXT = b"discovery v5 key agreement"

BUCKET_SIZE = 16
MAX_NODES_PER_MSG = 4  # ENRs per NODES packet (fits a 1280-byte datagram)


class Discv5Error(ValueError):
    pass


MAX_TRACKED = 1024


def _trim(d: dict, cap: int = MAX_TRACKED) -> None:
    """Evict oldest entries (insertion order) past the cap — both the
    pending-request and challenge maps are fed by unauthenticated traffic."""
    while len(d) > cap:
        d.pop(next(iter(d)))


def _aes_ctr(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    c = Cipher(algorithms.AES(key16), modes.CTR(iv16)).encryptor()
    return c.update(data) + c.finalize()


def _hkdf(salt: bytes, ikm: bytes, info: bytes, length: int = 32) -> bytes:
    prk = hmac_mod.new(salt, ikm, hashlib.sha256).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac_mod.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def _ecdh(priv: int, pub: tuple[int, int]) -> bytes:
    """discv5 ECDH: the COMPRESSED encoding of priv*pub (33 bytes) — unlike
    ECIES which keeps only x."""
    x, y = secp256k1._to_affine(secp256k1._jmul((pub[0], pub[1], 1), priv))
    return compress_pubkey((x, y))


def derive_session_keys(challenge_data: bytes, eph_priv: int | None,
                        eph_pub: tuple[int, int] | None,
                        static_priv: int | None, static_pub: tuple[int, int] | None,
                        src_id: bytes, dest_id: bytes) -> tuple[bytes, bytes]:
    """(initiator_key, recipient_key). The initiator supplies eph_priv +
    the peer's static pubkey; the recipient supplies its static_priv + the
    initiator's eph pubkey — both land on the same shared point."""
    if eph_priv is not None:
        shared = _ecdh(eph_priv, static_pub)
    else:
        shared = _ecdh(static_priv, eph_pub)
    info = KDF_INFO_TEXT + src_id + dest_id
    keys = _hkdf(challenge_data, shared, info, 32)
    return keys[:16], keys[16:]


def id_sign(priv: int, challenge_data: bytes, eph_pub_compressed: bytes,
            dest_id: bytes) -> bytes:
    digest = hashlib.sha256(
        ID_SIGNATURE_TEXT + challenge_data + eph_pub_compressed + dest_id
    ).digest()
    _y, r, s = secp256k1.sign(digest, priv)
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def id_verify(pub: tuple[int, int], sig: bytes, challenge_data: bytes,
              eph_pub_compressed: bytes, dest_id: bytes) -> bool:
    if len(sig) != 64:
        return False
    digest = hashlib.sha256(
        ID_SIGNATURE_TEXT + challenge_data + eph_pub_compressed + dest_id
    ).digest()
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    from ..primitives.secp256k1 import pubkey_to_bytes

    for y in (0, 1):
        try:
            if secp256k1.ecrecover(digest, y, r, s, allow_high_s=True,
                                   return_pubkey=True) == pubkey_to_bytes(pub):
                return True
        except Exception:  # noqa: BLE001 — wrong recovery bit
            continue
    return False


# -- packet codec -----------------------------------------------------------

def _header(flag: int, nonce: bytes, authdata: bytes) -> bytes:
    return (PROTOCOL_ID + VERSION + bytes([flag]) + nonce
            + len(authdata).to_bytes(2, "big") + authdata)


def mask_packet(dest_id: bytes, header: bytes, message: bytes,
                masking_iv: bytes | None = None) -> bytes:
    iv = masking_iv or os.urandom(16)
    return iv + _aes_ctr(dest_id[:16], iv, header) + message


def unmask_packet(local_id: bytes, raw: bytes) -> tuple[bytes, int, bytes, bytes, bytes]:
    """-> (masking_iv, flag, nonce, authdata, message). Header bytes are
    recovered by decrypting with OUR id as the masking key."""
    if len(raw) < 16 + 23:
        raise Discv5Error("packet too short")
    iv = raw[:16]
    # static header = 6 + 2 + 1 + 12 + 2 = 23 bytes, then authdata
    dec = Cipher(algorithms.AES(local_id[:16]), modes.CTR(iv)).decryptor()
    static = dec.update(raw[16:39])
    if static[:6] != PROTOCOL_ID or static[6:8] != VERSION:
        raise Discv5Error("bad protocol id")
    flag = static[8]
    nonce = static[9:21]
    authdata_len = int.from_bytes(static[21:23], "big")
    if len(raw) < 39 + authdata_len:
        raise Discv5Error("truncated authdata")
    authdata = dec.update(raw[39:39 + authdata_len])
    header = static + authdata
    message = raw[39 + authdata_len:]
    return iv, flag, nonce, authdata, message


# -- messages ---------------------------------------------------------------

def encode_message(mtype: int, fields: list) -> bytes:
    return bytes([mtype]) + rlp_encode(fields)


def decode_message(raw: bytes) -> tuple[int, list]:
    if not raw:
        raise Discv5Error("empty message")
    fields, consumed = rlp_decode_prefix(raw[1:])
    if consumed != len(raw) - 1:
        raise Discv5Error("trailing bytes")
    return raw[0], fields


class Session:
    __slots__ = ("initiator_key", "recipient_key", "we_initiated", "counter")

    def __init__(self, initiator_key: bytes, recipient_key: bytes,
                 we_initiated: bool):
        self.initiator_key = initiator_key
        self.recipient_key = recipient_key
        self.we_initiated = we_initiated
        self.counter = 0

    @property
    def send_key(self) -> bytes:
        return self.initiator_key if self.we_initiated else self.recipient_key

    @property
    def recv_key(self) -> bytes:
        return self.recipient_key if self.we_initiated else self.initiator_key


class RoutingTable:
    """256 xor buckets over raw 32-byte node ids."""

    def __init__(self, local_id: bytes):
        self.local_id = local_id
        self.by_id: dict[bytes, Enr] = {}

    @staticmethod
    def distance(a: bytes, b: bytes) -> int:
        return (int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).bit_length()

    def add(self, enr: Enr) -> None:
        nid = enr.node_id
        if nid == self.local_id:
            return
        old = self.by_id.get(nid)
        if old is None or enr.seq >= old.seq:
            self.by_id[nid] = enr

    def at_distance(self, d: int) -> list[Enr]:
        return [e for nid, e in self.by_id.items()
                if self.distance(self.local_id, nid) == d][:BUCKET_SIZE]

    def closest(self, target: bytes, n: int = BUCKET_SIZE) -> list[Enr]:
        t = int.from_bytes(target, "big")
        return sorted(self.by_id.values(),
                      key=lambda e: t ^ int.from_bytes(e.node_id, "big"))[:n]

    def __len__(self):
        return len(self.by_id)


class Discv5:
    """One discv5 endpoint: UDP listener, sessions, routing table."""

    def __init__(self, priv: int, host: str = "127.0.0.1", port: int = 0,
                 tcp_port: int = 0):
        self.priv = priv
        self.pub = pubkey_from_priv(priv)
        self.node_id = node_id_from_pubkey(self.pub)
        self.host = host
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.enr_seq = 1
        self.enr = make_enr(priv, ip=host, udp=self.port,
                            tcp=tcp_port or self.port, seq=self.enr_seq)
        self.table = RoutingTable(self.node_id)
        self.sessions: dict[bytes, Session] = {}          # node-id -> keys
        self._pending: dict[bytes, tuple[bytes, bytes, tuple]] = {}
        #   nonce -> (dest-id, plaintext message, addr) awaiting WHOAREYOU
        self._challenges: dict[bytes, bytes] = {}         # node-id -> challenge-data
        self._req_counter = 0
        self._waiters: dict[bytes, threading.Event] = {}  # request-id -> done
        self._results: dict[bytes, list] = {}
        self._chunks: dict[bytes, list[int]] = {}         # rid -> [got, total]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.RLock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.sock.close()

    # -- sending ------------------------------------------------------------

    def _next_request_id(self) -> bytes:
        with self._lock:
            self._req_counter += 1
            return self._req_counter.to_bytes(4, "big")

    def _send_ordinary(self, dest: Enr, message_pt: bytes) -> None:
        nid = dest.node_id
        addr = (dest.ip, dest.udp_port)
        nonce = os.urandom(12)
        with self._lock:
            session = self.sessions.get(nid)
            # ALWAYS remember the plaintext by nonce: if the peer lost its
            # session keys it answers WHOAREYOU referencing this nonce, and
            # the handshake retransmits the message (session repair)
            self._pending[nonce] = (nid, message_pt, addr)
            _trim(self._pending)
        header = _header(FLAG_ORDINARY, nonce, self.node_id)
        iv = os.urandom(16)
        if session is None:
            # no session yet: random payload provokes a WHOAREYOU challenge
            message = os.urandom(16)
        else:
            message = AESGCM(session.send_key).encrypt(nonce, message_pt,
                                                       iv + header)
        self.sock.sendto(mask_packet(nid, header, message, iv), addr)

    def _send_whoareyou(self, src_id: bytes, req_nonce: bytes, addr) -> None:
        id_nonce = os.urandom(16)
        known = self.table.by_id.get(src_id)
        enr_seq = known.seq if known else 0
        authdata = id_nonce + enr_seq.to_bytes(8, "big")
        header = _header(FLAG_WHOAREYOU, req_nonce, authdata)
        iv = os.urandom(16)
        with self._lock:
            self._challenges[src_id] = iv + header  # challenge-data
            _trim(self._challenges)  # spoofed src-ids must not grow memory
        self.sock.sendto(mask_packet(src_id, header, b"", iv), addr)

    def _send_handshake(self, dest_id: bytes, challenge_data: bytes,
                        enr_seq_known: int, message_pt: bytes, addr) -> None:
        eph_priv = random_priv()
        eph_pub_c = compress_pubkey(pubkey_from_priv(eph_priv))
        dest_enr = self.table.by_id.get(dest_id)
        if dest_enr is None:
            raise Discv5Error("cannot handshake with unknown record")
        ik, rk = derive_session_keys(challenge_data, eph_priv, None, None,
                                     dest_enr.pubkey, self.node_id, dest_id)
        sig = id_sign(self.priv, challenge_data, eph_pub_c, dest_id)
        authdata = (self.node_id + bytes([len(sig)]) + bytes([len(eph_pub_c)])
                    + sig + eph_pub_c)
        if enr_seq_known < self.enr_seq:
            authdata += self.enr.encode()
        nonce = os.urandom(12)
        header = _header(FLAG_HANDSHAKE, nonce, authdata)
        iv = os.urandom(16)
        message = AESGCM(ik).encrypt(nonce, message_pt, iv + header)
        with self._lock:
            self.sessions[dest_id] = Session(ik, rk, we_initiated=True)
        self.sock.sendto(mask_packet(dest_id, header, message, iv), addr)

    # -- rpc ----------------------------------------------------------------

    def ping(self, dest: Enr) -> None:
        rid = self._next_request_id()
        self._send_ordinary(dest, encode_message(
            PING, [rid, encode_int(self.enr_seq)]))

    def find_node(self, dest: Enr, distances: list[int],
                  wait: float = 0.0) -> list[Enr]:
        rid = self._next_request_id()
        ev = threading.Event()
        with self._lock:
            self._waiters[rid] = ev
            self._results[rid] = []
            self._chunks[rid] = [0, 1]
        self._send_ordinary(dest, encode_message(
            FINDNODE, [rid, [encode_int(d) for d in distances]]))
        if wait:
            ev.wait(wait)
        with self._lock:
            self._waiters.pop(rid, None)
            self._chunks.pop(rid, None)
            return self._results.pop(rid, [])

    def bootstrap(self, enrs: list[Enr | str]) -> None:
        for e in enrs:
            rec = Enr.from_base64(e) if isinstance(e, str) else e
            self.table.add(rec)
            self.ping(rec)

    def lookup(self, target: bytes | None = None, rounds: int = 3,
               wait: float = 0.5) -> list[Enr]:
        target = target or self.node_id
        seen: set[bytes] = set()
        for _ in range(rounds):
            with self._lock:
                cands = [e for e in self.table.closest(target, 6)
                         if e.node_id not in seen and e.node_id in self.sessions]
            for e in cands[:3]:
                seen.add(e.node_id)
                d = RoutingTable.distance(e.node_id, target)
                got = self.find_node(e, [d or 1, min(d + 1, 256), max(d - 1, 1)],
                                     wait=wait)
                for enr in got:
                    self.table.add(enr)
        return self.table.closest(target)

    # -- receive loop --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw, addr = self.sock.recvfrom(1500)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle_packet(raw, addr)
            except Exception:  # noqa: BLE001 — datagrams are attacker-
                # controlled; a parse/crypto failure drops the packet only
                continue

    def _handle_packet(self, raw: bytes, addr) -> None:
        iv, flag, nonce, authdata, message = unmask_packet(self.node_id, raw)
        header = _header(flag, nonce, authdata)
        if flag == FLAG_WHOAREYOU:
            self._on_whoareyou(iv, nonce, authdata, addr)
        elif flag == FLAG_ORDINARY:
            src_id = authdata[:32]
            with self._lock:
                session = self.sessions.get(src_id)
            if session is None:
                self._send_whoareyou(src_id, nonce, addr)
                return
            try:
                pt = AESGCM(session.recv_key).decrypt(nonce, message, iv + header)
            except Exception:  # noqa: BLE001 — stale/invalid session keys
                self._send_whoareyou(src_id, nonce, addr)
                return
            self._on_message(src_id, pt, addr)
        elif flag == FLAG_HANDSHAKE:
            self._on_handshake(iv, header, nonce, authdata, message, addr)

    def _on_whoareyou(self, iv: bytes, req_nonce: bytes, authdata: bytes,
                      addr) -> None:
        if len(authdata) != 24:
            raise Discv5Error("bad whoareyou authdata")
        enr_seq = int.from_bytes(authdata[16:24], "big")
        with self._lock:
            pend = self._pending.pop(req_nonce, None)
        if pend is None:
            return
        dest_id, message_pt, dest_addr = pend
        with self._lock:
            # the peer could not decrypt our message: any session we hold
            # for it is stale — the handshake below replaces it
            self.sessions.pop(dest_id, None)
        challenge_data = iv + _header(FLAG_WHOAREYOU, req_nonce, authdata)
        self._send_handshake(dest_id, challenge_data, enr_seq, message_pt,
                             dest_addr)

    def _on_handshake(self, iv: bytes, header: bytes, nonce: bytes,
                      authdata: bytes, message: bytes, addr) -> None:
        if len(authdata) < 34:
            raise Discv5Error("short handshake authdata")
        src_id = authdata[:32]
        sig_size = authdata[32]
        eph_size = authdata[33]
        off = 34
        sig = authdata[off:off + sig_size]
        off += sig_size
        eph_pub_c = authdata[off:off + eph_size]
        off += eph_size
        record = authdata[off:]
        with self._lock:
            challenge_data = self._challenges.pop(src_id, None)
        if challenge_data is None:
            raise Discv5Error("handshake without challenge")
        if record:
            enr = Enr.decode(record)
            if enr.node_id != src_id:
                raise Discv5Error("handshake record id mismatch")
            self.table.add(enr)
        src_enr = self.table.by_id.get(src_id)
        if src_enr is None:
            raise Discv5Error("handshake from unknown node without record")
        if not id_verify(src_enr.pubkey, sig, challenge_data, eph_pub_c,
                         self.node_id):
            raise Discv5Error("bad id signature")
        from ..primitives.secp256k1 import decompress_pubkey

        eph_pub = decompress_pubkey(eph_pub_c)
        ik, rk = derive_session_keys(challenge_data, None, eph_pub, self.priv,
                                     None, src_id, self.node_id)
        pt = AESGCM(ik).decrypt(nonce, message, iv + header)
        with self._lock:
            self.sessions[src_id] = Session(ik, rk, we_initiated=False)
        self._on_message(src_id, pt, addr)

    # -- message handling ----------------------------------------------------

    def _on_message(self, src_id: bytes, pt: bytes, addr) -> None:
        mtype, f = decode_message(pt)
        if mtype == PING:
            rid = bytes(f[0])
            self._respond(src_id, addr, encode_message(PONG, [
                rid, encode_int(self.enr_seq),
                socket.inet_aton(addr[0]), encode_int(addr[1]),
            ]))
        elif mtype == PONG:
            pass  # liveness noted via session existence
        elif mtype == FINDNODE:
            rid = bytes(f[0])
            distances = [decode_int(d) for d in f[1]]
            out: list[Enr] = []
            with self._lock:
                for d in distances[:8]:
                    if d == 0:
                        out.append(self.enr)
                    else:
                        out.extend(self.table.at_distance(d))
            chunks = [out[i:i + MAX_NODES_PER_MSG]
                      for i in range(0, len(out), MAX_NODES_PER_MSG)] or [[]]
            total = len(chunks)
            for chunk in chunks:
                records = [rlp_decode_prefix(e.encode())[0] for e in chunk]
                self._respond(src_id, addr, encode_message(
                    NODES, [rid, encode_int(total), records]))
        elif mtype == NODES:
            rid = bytes(f[0])
            with self._lock:
                sink = self._results.get(rid)
                ev = self._waiters.get(rid)
                chunks = self._chunks.get(rid)
            if sink is None:
                return
            for rec_fields in f[2]:
                try:
                    enr = Enr.decode(rlp_encode(rec_fields))
                except Exception:  # noqa: BLE001 — bad record from peer
                    continue
                sink.append(enr)
            # a multi-chunk response completes only when all `total`
            # messages arrived (capped: a malicious total can't stall the
            # waiter past its timeout)
            if chunks is not None:
                chunks[0] += 1
                chunks[1] = max(chunks[1], min(decode_int(f[1]), 64))
                if chunks[0] < chunks[1]:
                    return
            if ev is not None:
                ev.set()

    def _respond(self, dest_id: bytes, addr, message_pt: bytes) -> None:
        """Encrypted reply over the established session."""
        with self._lock:
            session = self.sessions.get(dest_id)
        if session is None:
            return
        nonce = os.urandom(12)
        header = _header(FLAG_ORDINARY, nonce, self.node_id)
        iv = os.urandom(16)
        message = AESGCM(session.send_key).encrypt(nonce, message_pt, iv + header)
        self.sock.sendto(mask_packet(dest_id, header, message, iv), addr)
