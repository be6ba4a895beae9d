"""ethstats: live node telemetry to an ethstats server over WebSocket.

A copy of the JAX package's ``ethstats.py`` over the port's node.

Reference analogue: crates/node/ethstats — `EthStatsService` keeps a WS
connection to the dashboard (url = "node:secret@host:port"), sends the
`hello` login, answers `node-ping` with `node-pong`, and pushes `stats`
/ `block` / `pending` emits on a cadence and on canonical change.

The WS client side (handshake with masking, RFC 6455 framing) lives
here; the server-side codec is shared from rpc/ws.py.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time


class EthStatsError(ConnectionError):
    pass


def _client_handshake(sock: socket.socket, host: str, path: str = "/api") -> None:
    key = base64.b64encode(os.urandom(16))
    sock.sendall(
        b"GET " + path.encode() + b" HTTP/1.1\r\n"
        b"Host: " + host.encode() + b"\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        b"Sec-WebSocket-Key: " + key + b"\r\n"
        b"Sec-WebSocket-Version: 13\r\n\r\n"
    )
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise EthStatsError("closed during handshake")
        data += chunk
    if b" 101 " not in data.split(b"\r\n", 1)[0]:
        raise EthStatsError("upgrade refused")


def _send_masked(sock: socket.socket, payload: bytes, opcode: int = 0x1) -> None:
    """Client frames must be masked (RFC 6455 5.1)."""
    mask = os.urandom(4)
    masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([0x80 | n])
    elif n < (1 << 16):
        header += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        header += bytes([0x80 | 127]) + struct.pack(">Q", n)
    sock.sendall(header + mask + masked)


def _recv_unmasked(sock: socket.socket,
                   idle_timeout: float | None = None) -> tuple[int, bytes] | None:
    """Server frames arrive unmasked. With ``idle_timeout``, returns None
    when NO frame has started within it; once the first byte arrives the
    whole frame is read under a long timeout — a timeout mid-frame would
    otherwise discard partial bytes and desync the stream permanently."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EthStatsError("connection closed")
            buf += chunk
        return buf

    if idle_timeout is not None:
        sock.settimeout(idle_timeout)
        try:
            first = exact(1)
        except socket.timeout:
            return None
        sock.settimeout(30.0)  # frame in flight: finish it or fail loudly
        b0, b1 = first[0], exact(1)[0]
    else:
        b0, b1 = exact(2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    ln = b1 & 0x7F
    if ln == 126:
        (ln,) = struct.unpack(">H", exact(2))
    elif ln == 127:
        (ln,) = struct.unpack(">Q", exact(8))
    mask = exact(4) if masked else None
    payload = exact(ln) if ln else b""
    if mask:
        payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return opcode, payload


def parse_ethstats_url(url: str) -> tuple[str, str, str, int]:
    """"node:secret@host:port" -> (node_name, secret, host, port)."""
    creds, _, addr = url.rpartition("@")
    name, _, secret = creds.partition(":")
    host, _, port = addr.partition(":")
    if not name or not host:
        raise ValueError("ethstats url must be node:secret@host:port")
    return name, secret, host, int(port or "3000")


class EthStatsService:
    """Reports a node's stats to an ethstats server until stopped."""

    def __init__(self, url: str, node, interval: float = 10.0):
        self.node_name, self.secret, self.host, self.port = parse_ethstats_url(url)
        self.node = node
        self.interval = interval
        self.sock: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- wire --------------------------------------------------------------

    def _emit(self, topic: str, payload: dict) -> None:
        msg = json.dumps({"emit": [topic, payload]}).encode()
        with self._lock:
            if self.sock is not None:
                _send_masked(self.sock, msg)

    def connect(self) -> None:
        # handshake on a local socket; publish under the lock only once
        # upgraded, so a concurrent _emit can never write a frame into the
        # raw HTTP upgrade stream
        sock = socket.create_connection((self.host, self.port), timeout=10)
        try:
            _client_handshake(sock, f"{self.host}:{self.port}")
        except Exception:
            sock.close()
            raise
        with self._lock:
            old, self.sock = self.sock, sock
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        self._emit("hello", {
            "id": self.node_name,
            "secret": self.secret,
            "info": {
                "name": self.node_name,
                "node": "reth-tpu/0.2",
                "protocol": "eth/68",
                "api": "No", "os": "linux", "os_v": "", "client": "0.2",
                "canUpdateHistory": True,
            },
        })

    # -- payloads ----------------------------------------------------------

    def _stats_payload(self) -> dict:
        peers = len(self.node.network.peers) if self.node.network else 0
        with self.node.factory.provider() as p:
            gas_price = self.node.eth_api.gas_oracle.suggest_gas_price(p)
        return {
            "id": self.node_name,
            "stats": {
                "active": True, "syncing": False, "mining": False,
                "hashrate": 0, "peers": peers,
                "gasPrice": gas_price,
                "uptime": 100,
            },
        }

    def _block_payload(self) -> dict:
        with self.node.factory.provider() as p:
            n = p.last_block_number()
            h = p.header_by_number(n)
        return {
            "id": self.node_name,
            "block": {
                "number": n,
                "hash": "0x" + h.hash.hex(),
                "parentHash": "0x" + h.parent_hash.hex(),
                "timestamp": h.timestamp,
                "gasUsed": h.gas_used,
                "gasLimit": h.gas_limit,
                "difficulty": "0",
                "totalDifficulty": "0",
                "transactions": [],
                "uncles": [],
            },
        }

    def report_block(self) -> None:
        # called from the engine's canon listener: never raise into it
        try:
            self._emit("block", self._block_payload())
        except Exception:  # noqa: BLE001 — the loop's reconnect recovers
            pass

    def report_stats(self) -> None:
        self._emit("stats", self._stats_payload())

    def report_pending(self) -> None:
        self._emit("pending", {
            "id": self.node_name,
            "stats": {"pending": len(self.node.pool) if self.node.pool else 0},
        })

    # -- service loop ------------------------------------------------------

    def start(self) -> None:
        self.connect()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        # push block reports on canonical change
        if getattr(self.node, "tree", None) is not None:
            self.node.tree.canon_listeners.append(lambda _chain: self.report_block())

    def _loop(self) -> None:
        last_report = 0.0
        while not self._stop.is_set():
            try:
                got = _recv_unmasked(self.sock, idle_timeout=0.5)
                op, payload = got if got is not None else (None, None)
                if op == 0x1 and payload:
                    try:
                        msg = json.loads(payload)
                        topic = (msg.get("emit") or [None])[0]
                    except Exception:  # noqa: BLE001 — a malformed frame
                        topic = None   # must not kill the telemetry thread
                    if topic == "node-ping":
                        self._emit("node-pong", {"id": self.node_name,
                                                 "clientTime": time.time()})
                if time.time() - last_report >= self.interval:
                    self.report_stats()
                    self.report_pending()
                    last_report = time.time()
            except (EthStatsError, OSError):
                # reconnect with backoff (the reference keeps retrying)
                if self._stop.wait(2.0):
                    return
                try:
                    self.connect()
                except OSError:
                    continue

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        with self._lock:
            if self.sock is not None:
                self.sock.close()
                self.sock = None
