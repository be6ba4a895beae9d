"""discv4: UDP Kademlia node discovery (ping/pong/findnode/neighbors).

Reference analogue: crates/net/discv4/src/lib.rs. Packet layout (devp2p):

  hash(32) = keccak256(signature || type || data)
  signature(65) = sign(keccak256(type || data)) as r(32)||s(32)||v(1)
  type(1), data = RLP list per message

Messages: Ping [vsn=4, from, to, expiration], Pong [to, ping-hash,
expiration], FindNode [target-pubkey, expiration], Neighbors [[nodes],
expiration]; endpoint = [ip, udp-port, tcp-port]. Node identity =
uncompressed secp256k1 public key; Kademlia distance =
xor(keccak(id-a), keccak(id-b)). Only bonded peers (recent pong) get
findnode answers (endpoint-proof rule).
"""

from __future__ import annotations

import ipaddress
import socket
import threading
import time

from ..primitives import secp256k1
from ..primitives.keccak import keccak256
from ..primitives.rlp import decode_int, encode_int, rlp_decode_prefix, rlp_encode
from ..primitives.secp256k1 import pubkey_from_bytes, pubkey_from_priv, pubkey_to_bytes

PING, PONG, FINDNODE, NEIGHBORS = 0x01, 0x02, 0x03, 0x04
VSN = 4
EXPIRATION = 20
BUCKET_SIZE = 16
BOND_TTL = 12 * 3600
ALPHA = 3  # lookup concurrency


class DiscError(ValueError):
    pass


def _endpoint(ip: str, udp: int, tcp: int) -> list:
    return [ipaddress.ip_address(ip).packed, encode_int(udp), encode_int(tcp)]


def _decode_endpoint(f) -> tuple[str, int, int]:
    return (str(ipaddress.ip_address(bytes(f[0]))) if f[0] else "0.0.0.0",
            decode_int(f[1]), decode_int(f[2]))


def encode_packet(priv: int, ptype: int, data: list) -> bytes:
    body = bytes([ptype]) + rlp_encode(data)
    y, r, s = secp256k1.sign(keccak256(body), priv)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([y])
    return keccak256(sig + body) + sig + body


def decode_packet(raw: bytes) -> tuple[bytes, bytes, int, list]:
    """-> (packet-hash, sender node id, type, fields)."""
    if len(raw) < 32 + 65 + 1:
        raise DiscError("packet too short")
    h, sig, body = raw[:32], raw[32:97], raw[97:]
    if keccak256(sig + body) != h:
        raise DiscError("bad packet hash")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    node = secp256k1.ecrecover(keccak256(body), sig[64], r, s,
                               allow_high_s=True, return_pubkey=True)
    fields, _ = rlp_decode_prefix(body[1:])
    return h, node, body[0], fields


def log_distance(a: bytes, b: bytes) -> int:
    """Kademlia bucket index: bit length of xor(keccak(a), keccak(b))."""
    x = int.from_bytes(keccak256(a), "big") ^ int.from_bytes(keccak256(b), "big")
    return x.bit_length()


class NodeRecord:
    __slots__ = ("node_id", "ip", "udp_port", "tcp_port", "last_pong")

    def __init__(self, node_id: bytes, ip: str, udp_port: int, tcp_port: int):
        self.node_id = node_id
        self.ip = ip
        self.udp_port = udp_port
        self.tcp_port = tcp_port
        self.last_pong = 0.0

    @property
    def bonded(self) -> bool:
        return time.monotonic() - self.last_pong < BOND_TTL if self.last_pong else False

    def enode(self) -> str:
        return f"enode://{self.node_id.hex()}@{self.ip}:{self.tcp_port}"


class KademliaTable:
    """256 xor-distance buckets of at most BUCKET_SIZE live records."""

    def __init__(self, local_id: bytes):
        self.local_id = local_id
        self.buckets: dict[int, list[NodeRecord]] = {}
        self.by_id: dict[bytes, NodeRecord] = {}

    def add(self, rec: NodeRecord) -> NodeRecord:
        existing = self.by_id.get(rec.node_id)
        if existing is not None:
            existing.ip, existing.udp_port, existing.tcp_port = (
                rec.ip, rec.udp_port, rec.tcp_port)
            return existing
        d = log_distance(self.local_id, rec.node_id)
        bucket = self.buckets.setdefault(d, [])
        if len(bucket) >= BUCKET_SIZE:
            # evict the stalest unbonded entry; full-of-bonded drops the new
            stale = min((r for r in bucket if not r.bonded),
                        key=lambda r: r.last_pong, default=None)
            if stale is None:
                return rec
            bucket.remove(stale)
            self.by_id.pop(stale.node_id, None)
        bucket.append(rec)
        self.by_id[rec.node_id] = rec
        return rec

    def closest(self, target_id: bytes, n: int = BUCKET_SIZE) -> list[NodeRecord]:
        t = int.from_bytes(keccak256(target_id), "big")
        return sorted(
            self.by_id.values(),
            key=lambda r: t ^ int.from_bytes(keccak256(r.node_id), "big"),
        )[:n]

    def __len__(self) -> int:
        return len(self.by_id)


class Discv4:
    """One discovery endpoint: UDP listener + Kademlia table + lookups."""

    def __init__(self, node_priv: int, host: str = "127.0.0.1", port: int = 0,
                 tcp_port: int = 0):
        self.priv = node_priv
        self.node_id = pubkey_to_bytes(pubkey_from_priv(node_priv))
        self.host = host
        self.tcp_port = tcp_port
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.table = KademliaTable(self.node_id)
        self._pending_pings: dict[bytes, NodeRecord] = {}  # ping-hash -> rec
        self._neighbors_waiters: list = []
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

    def enode(self) -> str:
        tcp = self.tcp_port or self.port
        url = f"enode://{self.node_id.hex()}@{self.host}:{tcp}"
        if self.port != tcp:
            url += f"?discport={self.port}"  # standard split-port form
        return url

    # -- outbound -----------------------------------------------------------

    def _send(self, addr, ptype: int, data: list) -> bytes:
        pkt = encode_packet(self.priv, ptype, data)
        self.sock.sendto(pkt, addr)
        return pkt[:32]

    def _expiration(self) -> bytes:
        return encode_int(int(time.time()) + EXPIRATION)

    def ping(self, rec: NodeRecord) -> None:
        data = [
            encode_int(VSN),
            _endpoint(self.host, self.port, self.tcp_port or self.port),
            _endpoint(rec.ip, rec.udp_port, rec.tcp_port),
            self._expiration(),
        ]
        pkt = encode_packet(self.priv, PING, data)
        with self._lock:
            # register BEFORE sendto: on loopback the PONG can beat the
            # sender back to the bookkeeping and the bond would be lost
            self._pending_pings[pkt[:32]] = rec
        self.sock.sendto(pkt, (rec.ip, rec.udp_port))

    def find_node(self, rec: NodeRecord, target_id: bytes) -> None:
        self._send((rec.ip, rec.udp_port), FINDNODE,
                   [target_id, self._expiration()])

    def bootstrap(self, enodes: list[str]) -> None:
        from .server import parse_enode

        for url in enodes:
            url, _, query = url.partition("?")
            pub, host, tcp = parse_enode(url)
            udp = tcp
            if query.startswith("discport="):
                udp = int(query[len("discport="):])
            rec = NodeRecord(pubkey_to_bytes(pub), host, udp, tcp)
            with self._lock:
                rec = self.table.add(rec)
            self.ping(rec)

    def lookup(self, target_id: bytes | None = None, rounds: int = 3,
               wait: float = 0.5) -> list[NodeRecord]:
        """Iterative FINDNODE toward ``target_id`` (default: self — the
        bootstrap self-lookup that populates the table)."""
        target = target_id or self.node_id
        seen: set[bytes] = set()
        for _ in range(rounds):
            with self._lock:
                candidates = [r for r in self.table.closest(target, ALPHA * 2)
                              if r.bonded and r.node_id not in seen]
            for rec in candidates[:ALPHA]:
                seen.add(rec.node_id)
                self.find_node(rec, target)
            time.sleep(wait)
        with self._lock:
            return self.table.closest(target)

    # -- inbound ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw, addr = self.sock.recvfrom(1500)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                h, node, ptype, fields = decode_packet(raw)
                self._handle(h, node, ptype, fields, addr)
            except Exception:  # noqa: BLE001 — packet fields are attacker-
                # controlled; any parse error drops the packet, not the loop
                continue

    def _expired(self, exp_field) -> bool:
        return decode_int(exp_field) < time.time()

    def _handle(self, h: bytes, node: bytes, ptype: int, f: list, addr) -> None:
        if node == self.node_id:
            return
        if ptype == PING:
            if self._expired(f[3]):
                return
            # observed ip/udp (anti-spoof) + the sender's DECLARED tcp port
            try:
                _, _, tcp = _decode_endpoint(f[1])
            except (ValueError, IndexError):
                tcp = addr[1]
            rec = NodeRecord(node, addr[0], addr[1], tcp or addr[1])
            with self._lock:
                rec = self.table.add(rec)
            self._send(addr, PONG,
                       [_endpoint(addr[0], addr[1], addr[1]), h, self._expiration()])
            if not rec.bonded:
                self.ping(rec)  # bond both ways
        elif ptype == PONG:
            ping_hash = bytes(f[1])
            with self._lock:
                rec = self._pending_pings.pop(ping_hash, None)
            if rec is not None and rec.node_id == node:
                rec.last_pong = time.monotonic()
        elif ptype == FINDNODE:
            if self._expired(f[1]):
                return
            with self._lock:
                rec = self.table.by_id.get(node)
                if rec is None or not rec.bonded:
                    return  # endpoint proof required
                closest = self.table.closest(bytes(f[0]))
            nodes = [
                _endpoint(r.ip, r.udp_port, r.tcp_port) + [r.node_id]
                for r in closest
            ]
            self._send(addr, NEIGHBORS, [nodes, self._expiration()])
        elif ptype == NEIGHBORS:
            for nf in f[0]:
                ip, udp, tcp = _decode_endpoint(nf[:3])
                nid = bytes(nf[3])
                if nid == self.node_id:
                    continue
                try:
                    pubkey_from_bytes(nid)
                except ValueError:
                    continue
                rec = NodeRecord(nid, ip, udp, tcp)
                with self._lock:
                    known = rec.node_id in self.table.by_id
                    rec = self.table.add(rec)
                if not known and not rec.bonded:
                    self.ping(rec)
