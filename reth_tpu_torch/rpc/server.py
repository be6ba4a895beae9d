"""Threaded JSON-RPC 2.0 HTTP server with a method registry.

A copy of the JAX package's ``rpc/server.py``. One departure: a kernel fault
(``ops/_build.is_kernel_fault``) under a handler is no -32603 error. It is
counted in ``RpcServer.kernel_faults`` and re-raised out of ``handle()``; the
transports catch it only at their edge, keep the first one on the server
(``kernel_fault``) and answer HTTP 500 or close the connection, never with a
JSON ``result``. Any other exception maps to -32603, as in the reference.
Not ported yet: ``/health`` (it answers 404) and the fleet scope of
``/metrics`` (``?scope=fleet`` renders this node's registry alone).

Reference analogue: the rpc-builder server assembly + transport layers
(crates/rpc/rpc-builder/src/lib.rs) — trimmed to HTTP; the method
registry takes `namespace_method` callables from API objects.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import tracing
from ..ops._build import is_kernel_fault


class RpcError(Exception):
    def __init__(self, code: int, message: str, data=None):
        super().__init__(message)
        self.code = code
        self.message = message
        # optional structured error payload (JSON-RPC error.data), e.g.
        # the gateway's {"retry_after": ...} on -32005 shedding
        self.data = data


PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


class RpcServer:
    """Registry + HTTP transport. ``register(api)`` scans an API object for
    ``namespace_method``-named callables (e.g. ``eth_blockNumber``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 lock: threading.RLock | None = None,
                 jwt_secret: bytes | None = None,
                 gateway=None):
        self.methods: dict[str, callable] = {}
        self.host = host
        self.port = port
        # HS256 JWT required on every request when set (the engine auth
        # port; reference crates/rpc/rpc-layer/src/auth_layer.rs)
        self.jwt_secret = jwt_secret
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # one coarse lock serialises handlers: pool/tree state has no
        # internal synchronisation (share the lock across servers that
        # share state, e.g. the public and auth servers of one node)
        self.lock = lock or threading.RLock()
        # serving gateway (rpc/gateway.py): every dispatch — HTTP here,
        # plus the WS/IPC transports that wrap this registry — routes
        # through it for admission control, coalescing, and the
        # head-invalidated response cache (None = direct dispatch)
        self.gateway = gateway
        # kernel faults re-raised out of handle(); the first one a
        # transport caught at its edge
        self.kernel_faults = 0
        self.kernel_fault: BaseException | None = None
        self._fault_lock = threading.Lock()

    def keep_fault(self, err: BaseException) -> None:
        """A transport's edge: keep the first kernel fault it caught."""
        with self._fault_lock:
            if self.kernel_fault is None:
                self.kernel_fault = err

    def authorize(self, auth_header: str | None) -> str | None:
        """None when authorized; else the rejection reason."""
        if self.jwt_secret is None:
            return None
        if not auth_header or not auth_header.startswith("Bearer "):
            return "missing JWT bearer token"
        from .jwt import JwtError, validate_jwt

        try:
            validate_jwt(self.jwt_secret, auth_header[7:].strip())
        except JwtError as e:
            return str(e)
        return None

    def register(self, api: object, prefix: str | None = None):
        for name in dir(api):
            if name.startswith("_"):
                continue
            fn = getattr(api, name)
            if callable(fn) and "_" in name:
                self.methods[name] = fn

    def register_method(self, name: str, fn):
        self.methods[name] = fn

    # -- dispatch --------------------------------------------------------------

    def handle(self, body: bytes) -> bytes:
        try:
            req = json.loads(body)
        except json.JSONDecodeError:
            return self._error(None, PARSE_ERROR, "parse error")
        if isinstance(req, list):
            return json.dumps([json.loads(self._handle_one(r)) for r in req]).encode()
        return self._handle_one(req)

    def _handle_one(self, req) -> bytes:
        rid = req.get("id") if isinstance(req, dict) else None
        if not isinstance(req, dict) or "method" not in req:
            return self._error(rid, INVALID_REQUEST, "invalid request")
        method = req["method"]
        fn = self.methods.get(method)
        if fn is None:
            return self._error(rid, METHOD_NOT_FOUND, f"method {method} not found")
        params = req.get("params", [])

        def invoke():
            if getattr(fn, "_lockfree", False):
                # handlers that only touch self-locking components (the
                # tx batcher/pool) skip the global lock: holding it while
                # awaiting a batched insert would serialize the batcher
                # down to batches of one and stall unrelated RPCs
                return fn(*params) if isinstance(params, list) else fn(**params)
            with self.lock:
                return fn(*params) if isinstance(params, list) else fn(**params)

        # cross-process trace adoption: a fleet-routed request carries
        # its originating gateway span as a wire-form "traceparent"
        # member (fleet/ring.py) — adopt it so every span this dispatch
        # records (the local gateway's admission span included) stitches
        # under the remote caller's trace with a resolvable parent id
        remote_ctx = tracing.context_from_wire(req.get("traceparent"))
        try:
            if remote_ctx is not None and tracing.trace_enabled():
                with tracing.use_context(remote_ctx):
                    with tracing.span("rpc::server", "rpc.serve",
                                      method=method):
                        if self.gateway is not None:
                            result = self.gateway.call(method, params, invoke)
                        else:
                            result = invoke()
            elif self.gateway is not None:
                result = self.gateway.call(method, params, invoke)
            else:
                result = invoke()
        except Exception as e:  # noqa: BLE001 — every other fault maps to an RPC error
            if is_kernel_fault(e):
                with self._fault_lock:
                    self.kernel_faults += 1
                raise
            if isinstance(e, RpcError):
                return self._error(rid, e.code, e.message, e.data)
            if isinstance(e, TypeError):
                return self._error(rid, INVALID_PARAMS, str(e))
            return self._error(rid, INTERNAL_ERROR, f"{type(e).__name__}: {e}")
        return json.dumps({"jsonrpc": "2.0", "id": rid, "result": result}).encode()

    def _error(self, rid, code, message, data=None) -> bytes:
        err = {"code": code, "message": message}
        if data is not None:
            err["data"] = data
        return json.dumps({
            "jsonrpc": "2.0", "id": rid, "error": err,
        }).encode()

    # -- transport -------------------------------------------------------------

    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                denied = server.authorize(self.headers.get("Authorization"))
                if denied is not None:
                    resp = json.dumps({"jsonrpc": "2.0", "id": None, "error": {
                        "code": -32001, "message": f"unauthorized: {denied}"}}).encode()
                    self.send_response(401)
                else:
                    try:
                        resp = server.handle(body)
                    except Exception as e:
                        if not is_kernel_fault(e):
                            raise
                        server.keep_fault(e)
                        self.send_response(500)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)

            def do_GET(self):
                path, _, _query = self.path.partition("?")
                if path == "/metrics":
                    from ..metrics import REGISTRY, update_process_metrics

                    update_process_metrics()
                    body = REGISTRY.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
