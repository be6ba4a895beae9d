"""WebSocket JSON-RPC transport (RFC 6455, stdlib-only).

A copy of the JAX package's ``rpc/ws.py``. A kernel fault re-raised out of
the registry's ``handle()`` is kept on that server (``RpcServer.keep_fault``)
and closes the connection: the client gets no answer to that frame.

Reference analogue: the WS transport of the rpc-builder server stack
(crates/rpc/rpc-builder per-transport assembly). One server wraps an
existing RpcServer's method registry: each connection upgrades via the
Sec-WebSocket-Accept handshake, then every text frame is dispatched as a
JSON-RPC request and answered on the same socket. Frames from clients
are masked per spec; fragmentation and ping/pong are handled.
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading

from ..ops._build import is_kernel_fault

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10
MAX_MESSAGE = 32 * 1024 * 1024


class WsError(ConnectionError):
    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WsError("connection closed")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> tuple[int, bool, bytes]:
    """-> (opcode, fin, payload); client frames MUST be masked (RFC 6455
    5.1: servers close the connection on an unmasked client frame)."""
    b0, b1 = _recv_exact(sock, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    if not masked:
        raise WsError("unmasked client frame")
    ln = b1 & 0x7F
    if ln == 126:
        (ln,) = struct.unpack(">H", _recv_exact(sock, 2))
    elif ln == 127:
        (ln,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if ln > MAX_MESSAGE:
        raise WsError("frame too large")
    mask = _recv_exact(sock, 4) if masked else None
    payload = _recv_exact(sock, ln) if ln else b""
    if mask:
        payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return opcode, fin, payload


def write_frame(sock: socket.socket, opcode: int, payload: bytes) -> None:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(header + payload)


def accept_handshake(sock: socket.socket) -> None:
    """Read the HTTP upgrade request and answer 101."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise WsError("closed during handshake")
        data += chunk
        if len(data) > 64 * 1024:
            raise WsError("oversized handshake")
    headers = {}
    for line in data.split(b"\r\n")[1:]:
        name, _, value = line.partition(b":")
        if value:
            headers[name.strip().lower()] = value.strip()
    key = headers.get(b"sec-websocket-key")
    if key is None or b"websocket" not in headers.get(b"upgrade", b"").lower():
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        raise WsError("not a websocket upgrade")
    accept = base64.b64encode(hashlib.sha1(key + _WS_GUID).digest())
    sock.sendall(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n"
    )


class WsRpcServer:
    """Serves an RpcServer's registry over WebSocket connections."""

    def __init__(self, rpc, host: str = "127.0.0.1", port: int = 0):
        self.rpc = rpc
        self.host = host
        self.port = port
        self._listener: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()

    def start(self) -> int:
        self._listener = socket.create_server((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._listener:
            self._listener.close()
        for sock in list(self._conns):  # stop serving established clients
            try:
                sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            self._conns.append(sock)
            threading.Thread(target=self._serve, args=(sock,), daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            accept_handshake(sock)
            message = b""
            while not self._stop.is_set():
                opcode, fin, payload = read_frame(sock)
                if opcode == OP_CLOSE:
                    write_frame(sock, OP_CLOSE, payload[:2])
                    return
                if opcode == OP_PING:
                    write_frame(sock, OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                message += payload
                if len(message) > MAX_MESSAGE:
                    raise WsError("message too large")
                if not fin:
                    continue
                try:
                    resp = self.rpc.handle(message)
                except Exception as e:
                    if not is_kernel_fault(e):
                        raise
                    self.rpc.keep_fault(e)
                    return
                message = b""
                write_frame(sock, OP_TEXT, resp)
        except (WsError, OSError):
            pass
        finally:
            try:
                self._conns.remove(sock)
            except ValueError:
                pass
            try:
                sock.close()
            except OSError:
                pass
