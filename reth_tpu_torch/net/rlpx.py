"""RLPx framed transport: AES-CTR frames, keccak MACs, Hello, snappy.

Reference analogue: crates/net/eth-wire/src (RLPx multiplexing + p2p
handshake + snappy) over crates/net/ecies. After the ECIES auth/ack
handshake (net/ecies.py) every message travels in MAC-authenticated
AES-256-CTR frames:

  header (16B): frame-size (3B BE) ++ RLP [capability-id=0, context-id=0]
                zero-padded; encrypted with the session-long CTR stream.
  header-mac (16B): egress-mac.update(aes-ecb(mac-key, egress-mac[:16])
                XOR header-ciphertext); take 16 bytes.
  frame-data: ciphertext of the padded (16B multiple) message, then
  frame-mac over it (same construction, seeded with frame-mac[:16]).

Message payload = msg-id (single RLP int) ++ snappy(body) once both
sides have Hello'd with p2p version >= 5. p2p base protocol messages
(Hello 0x00, Disconnect 0x01, Ping 0x02, Pong 0x03) are never compressed
before Hello completes.
"""

from __future__ import annotations

import os
import socket
import struct

from ..primitives.rlp import decode_int, encode_int, rlp_decode, rlp_encode
from ..primitives.secp256k1 import pubkey_from_priv, pubkey_to_bytes
from . import snappy
from ._aes import Cipher, algorithms, modes  # the port's AES, csrc/aes.cpp
from .ecies import FrameSecrets, Handshake

P2P_VERSION = 5
MAX_FRAME = 16 * 1024 * 1024

HELLO_ID = 0x00
DISCONNECT_ID = 0x01
PING_ID = 0x02
PONG_ID = 0x03
BASE_PROTOCOL_OFFSET = 0x10  # capability messages start here


class RlpxError(ConnectionError):
    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise RlpxError("connection closed")
        buf += chunk
    return buf


class RlpxSession:
    """An established encrypted session: send_msg/recv_msg of (id, body).

    Build with :func:`initiate` or :func:`respond`."""

    def __init__(self, sock: socket.socket, secrets: FrameSecrets,
                 remote_pub: tuple[int, int]):
        self.sock = sock
        self.remote_pub = remote_pub
        self.remote_node_id = pubkey_to_bytes(remote_pub)
        self._egress_mac = secrets.egress_mac
        self._ingress_mac = secrets.ingress_mac
        self._mac_cipher = Cipher(algorithms.AES(secrets.mac), modes.ECB())
        # one CTR stream per direction for the life of the session
        zero_iv = b"\x00" * 16
        self._enc = Cipher(algorithms.AES(secrets.aes), modes.CTR(zero_iv)).encryptor()
        self._dec = Cipher(algorithms.AES(secrets.aes), modes.CTR(zero_iv)).decryptor()
        self.snappy_enabled = False
        self.remote_hello: dict | None = None
        # non-blocking receive state (swarm mode): buffered ciphertext +
        # the header/body phase of the in-flight frame. The CTR stream and
        # rolling MACs are strictly ordered, so feed_frames consumes bytes
        # exactly once, in order.
        self._rx = bytearray()
        self._rx_size: int | None = None   # None = waiting for a header
        self._rx_padded = 0
        # swarm mode send sink: frames are fully encrypted under the
        # caller's lock, then handed to the sink (an outbox) instead of
        # blocking in sendall
        self._send_sink = None

    # -- MAC construction ---------------------------------------------------

    def _mac_step(self, mac, data16: bytes) -> bytes:
        enc = self._mac_cipher.encryptor()
        aes_block = enc.update(mac.digest()[:16])
        mac.update(bytes(a ^ b for a, b in zip(aes_block, data16)))
        return mac.digest()[:16]

    def _frame_mac(self, mac, ciphertext: bytes) -> bytes:
        mac.update(ciphertext)
        seed = mac.digest()[:16]
        return self._mac_step(mac, seed)

    # -- frames -------------------------------------------------------------

    def send_frame(self, payload: bytes) -> None:
        if len(payload) > MAX_FRAME:
            raise RlpxError("frame too large")
        header = struct.pack(">I", len(payload))[1:] + rlp_encode([b"", b""])
        header = header.ljust(16, b"\x00")
        header_ct = self._enc.update(header)
        header_mac = self._mac_step(self._egress_mac, header_ct)
        padded = payload + b"\x00" * (-len(payload) % 16)
        frame_ct = self._enc.update(padded)
        frame_mac = self._frame_mac(self._egress_mac, frame_ct)
        data = header_ct + header_mac + frame_ct + frame_mac
        if self._send_sink is not None:
            self._send_sink(data)
        else:
            self.sock.sendall(data)

    def recv_frame(self) -> bytes:
        header_ct = _recv_exact(self.sock, 16)
        header_mac = _recv_exact(self.sock, 16)
        if self._mac_step(self._ingress_mac, header_ct) != header_mac:
            raise RlpxError("bad header MAC")
        header = self._dec.update(header_ct)
        size = int.from_bytes(header[:3], "big")
        if size > MAX_FRAME:
            raise RlpxError("frame too large")
        padded = size + (-size % 16)
        frame_ct = _recv_exact(self.sock, padded)
        frame_mac = _recv_exact(self.sock, 16)
        if self._frame_mac(self._ingress_mac, frame_ct) != frame_mac:
            raise RlpxError("bad frame MAC")
        return self._dec.update(frame_ct)[:size]

    def feed_frames(self, data: bytes) -> list[bytes]:
        """Non-blocking counterpart of recv_frame: buffer ciphertext and
        return every complete frame it now contains (swarm receive path)."""
        self._rx += data
        frames: list[bytes] = []
        while True:
            if self._rx_size is None:
                if len(self._rx) < 32:
                    break
                header_ct = bytes(self._rx[:16])
                header_mac = bytes(self._rx[16:32])
                del self._rx[:32]
                if self._mac_step(self._ingress_mac, header_ct) != header_mac:
                    raise RlpxError("bad header MAC")
                header = self._dec.update(header_ct)
                size = int.from_bytes(header[:3], "big")
                if size > MAX_FRAME:
                    raise RlpxError("frame too large")
                self._rx_size = size
                self._rx_padded = size + (-size % 16)
            else:
                total = self._rx_padded + 16
                if len(self._rx) < total:
                    break
                frame_ct = bytes(self._rx[:self._rx_padded])
                frame_mac = bytes(self._rx[self._rx_padded:total])
                del self._rx[:total]
                if self._frame_mac(self._ingress_mac, frame_ct) != frame_mac:
                    raise RlpxError("bad frame MAC")
                frames.append(self._dec.update(frame_ct)[:self._rx_size])
                self._rx_size = None
        return frames

    # -- messages -----------------------------------------------------------

    def send_msg(self, msg_id: int, body: bytes) -> None:
        if self.snappy_enabled and msg_id >= BASE_PROTOCOL_OFFSET:
            body = snappy.compress(body)
        self.send_frame(rlp_encode(encode_int(msg_id)) + body)

    def parse_frame(self, frame: bytes) -> tuple[int, bytes]:
        """One received frame -> (msg_id, body) with snappy handling."""
        if not frame:
            raise RlpxError("empty frame")
        # msg-id is a single RLP item (0x80 = 0)
        if frame[0] < 0x80:
            msg_id, body = frame[0], frame[1:]
        elif frame[0] == 0x80:
            msg_id, body = 0, frame[1:]
        else:
            raise RlpxError("malformed message id")
        if self.snappy_enabled and msg_id >= BASE_PROTOCOL_OFFSET:
            body = snappy.decompress(body)
        return msg_id, body

    def recv_msg(self) -> tuple[int, bytes]:
        return self.parse_frame(self.recv_frame())

    # -- p2p base protocol --------------------------------------------------

    def hello(self, node_priv: int, client_id: str,
              caps: list[tuple[str, int]], port: int = 0) -> dict:
        """Exchange Hello messages; enables snappy; returns the remote's."""
        ours = rlp_encode([
            encode_int(P2P_VERSION), client_id.encode(),
            [[name.encode(), encode_int(v)] for name, v in caps],
            encode_int(port),
            pubkey_to_bytes(pubkey_from_priv(node_priv)),
        ])
        self.send_msg(HELLO_ID, ours)
        msg_id, body = self.recv_msg()
        if msg_id == DISCONNECT_ID:
            reason = rlp_decode(body)
            code = decode_int(reason[0] if isinstance(reason, list) else reason)
            raise RlpxError(f"peer disconnected during hello (reason {code})")
        if msg_id != HELLO_ID:
            raise RlpxError(f"expected Hello, got msg {msg_id}")
        f = rlp_decode(body)
        remote = {
            "p2p_version": decode_int(f[0]),
            "client_id": f[1].decode(errors="replace"),
            "caps": [(c[0].decode(errors="replace"), decode_int(c[1])) for c in f[2]],
            "port": decode_int(f[3]),
            "node_id": f[4],
        }
        self.remote_hello = remote
        if remote["node_id"] != self.remote_node_id:
            raise RlpxError("hello node-id does not match handshake identity")
        self.snappy_enabled = min(P2P_VERSION, remote["p2p_version"]) >= 5
        return remote

    def disconnect(self, reason: int = 0x08) -> None:
        try:
            self.send_msg(DISCONNECT_ID, rlp_encode([encode_int(reason)]))
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def initiate(sock: socket.socket, node_priv: int,
             remote_pub: tuple[int, int]) -> RlpxSession:
    """Dial-side ECIES handshake over an open socket."""
    h = Handshake(node_priv)
    auth = h.auth(remote_pub)
    sock.sendall(auth)
    size = _recv_exact(sock, 2)
    ack = size + _recv_exact(sock, struct.unpack(">H", size)[0])
    secrets = h.finalize_initiator(ack)
    return RlpxSession(sock, secrets, remote_pub)


def respond(sock: socket.socket, node_priv: int) -> RlpxSession:
    """Listen-side ECIES handshake over an accepted socket."""
    size = _recv_exact(sock, 2)
    auth = size + _recv_exact(sock, struct.unpack(">H", size)[0])
    h = Handshake(node_priv)
    ack, secrets = h.on_auth(auth)
    sock.sendall(ack)
    return RlpxSession(sock, secrets, h.remote_pub)


def node_id(priv: int) -> bytes:
    return pubkey_to_bytes(pubkey_from_priv(priv))
