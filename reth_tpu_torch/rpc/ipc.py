"""IPC JSON-RPC transport: Unix domain socket, newline-delimited JSON.

A copy of the JAX package's ``rpc/ipc.py``. A kernel fault re-raised out of
the registry's ``handle()`` is kept on that server (``RpcServer.keep_fault``)
and closes the connection: the client gets no answer to that line.

Reference analogue: crates/rpc/ipc (the jsonrpsee IPC transport). One
server wraps an existing RpcServer's method registry; each connection
streams newline-terminated JSON-RPC requests and receives one response
line per request (the geth-compatible framing local tooling expects).
"""

from __future__ import annotations

import os
import socket
import threading

from ..ops._build import is_kernel_fault

MAX_LINE = 32 * 1024 * 1024


class IpcRpcServer:
    def __init__(self, rpc, path):
        self.rpc = rpc
        self.path = str(path)
        self._listener: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()

    def start(self) -> str:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.path)
        os.chmod(self.path, 0o600)  # local node control: owner only
        self._listener.listen()
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self.path

    def stop(self) -> None:
        self._stop.set()
        if self._listener:
            self._listener.close()
        for sock in list(self._conns):
            try:
                sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(sock)
            threading.Thread(target=self._serve, args=(sock,), daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = sock.recv(65536)
                if not chunk:
                    return
                buf += chunk
                if len(buf) > MAX_LINE:
                    return
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    if not line.strip():
                        continue
                    try:
                        resp = self.rpc.handle(line)
                    except Exception as e:
                        if not is_kernel_fault(e):
                            raise
                        self.rpc.keep_fault(e)
                        return
                    sock.sendall(resp + b"\n")
        except OSError:
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
