"""The port's JSON-RPC transports (rpc/server.py, jwt.py, ws.py, ipc.py,
gateway.py) against the JAX package's, on the CPU.

Dispatch, batches and every error code are held equal byte for byte on the
same registry; the cases of tests/test_jwt.py, test_ipc.py and the
test_gateway.py cases that need no node run on both packages (their
timing-based ordering cases stay in test_gateway.py); tokens are accepted
across the packages; ``GET /metrics`` renders the process gauges.

What is not ported yet is pinned: ``/health`` answers 404, and the health,
SLO and fleet methods and ``debug_flightRecorder(action="correlated")`` are
not served. The departure: a kernel fault under a handler (a
``LaunchError``, a CUDA ``RuntimeError``, also on a ``__cause__`` chain and
through the gateway) is counted in ``RpcServer.kernel_faults`` and
re-raised out of ``handle()``; HTTP answers 500, WS and IPC close the
connection, the server keeps the first fault, and no JSON ``result`` is sent.
Only ephemeral ports; every server is stopped and its threads joined.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import pytest

from _torch_rpc_pkgs import RPORT, RREF, RpcNode, both, http, request, wallets_builder
from reth_tpu import metrics as jmetrics
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.primitives.keccak import keccak256
from reth_tpu_torch import metrics as pmetrics
from reth_tpu_torch.storage import MemDb as PMemDb
from reth_tpu_torch.storage import ProviderFactory as PFactory
from reth_tpu_torch.ops._build import LaunchError

PKGS = pytest.mark.parametrize("P", [RREF, RPORT], ids=["reference", "port"])
SECRET = bytes(range(32))


def _registry(P):
    return (jmetrics if P is RREF else pmetrics).MetricsRegistry()


def make_gateway(P, **kw):
    kw.setdefault("registry", _registry(P))
    return P.gateway.RpcGateway(**kw)


def handle(server, method, params, rid=1):
    return json.loads(server.handle(json.dumps(
        {"jsonrpc": "2.0", "id": rid, "method": method, "params": params}).encode()))


# -- dispatch, batches, error codes --------------------------------------------


class _Api:
    def __init__(self, P):
        self.P = P

    def test_echo(self, x, y=0):
        return [x, y]

    def test_fail(self):
        raise self.P.server.RpcError(-32042, "custom", data={"retry_after": 1.5})

    def test_boom(self):
        raise ValueError("boom")

    def test_none(self):
        return None

    def _private_x(self):  # never registered
        return "no"


def sc_dispatch(P):
    srv = P.server.RpcServer()
    srv.register(_Api(P))
    srv.register_method("plain", lambda: "p")
    bodies = [
        request("test_echo", 1, 2), request("test_echo", 5),
        json.dumps({"jsonrpc": "2.0", "id": "s", "method": "test_echo",
                    "params": {"x": 3, "y": 4}}).encode(),
        request("test_echo"), request("test_echo", 1, 2, 3), request("test_fail"),
        request("test_boom"), request("test_none"), request("no_such"),
        request("_private_x"), request("plain"), b"{not json",
        json.dumps({"jsonrpc": "2.0", "id": 7}).encode(), b'"string"', b"[]",
        json.dumps([json.loads(request("test_echo", 9, rid=1)), {"id": 2},
                    json.loads(request("test_fail", rid=3)), 5,
                    json.loads(request("no_such", rid=4))]).encode(),
        json.dumps({"jsonrpc": "2.0", "id": None, "method": "test_echo", "params": [0],
                    "traceparent": {"t": "ab", "s": 3}}).encode(),
    ]
    return [srv.handle(b) for b in bodies] + [sorted(srv.methods).__repr__().encode()]


def test_dispatch_batches_and_error_codes_match_reference():
    got = both(sc_dispatch)
    codes = [json.loads(r).get("error", {}).get("code") for r in got[:14]]
    assert codes == [None, None, None, -32602, -32602, -32042, -32603, None, -32601,
                     -32601, None, -32700, -32600, -32600]
    assert got[14] == b"[]"
    assert [o.get("error", {}).get("code") for o in json.loads(got[15])] == \
        [None, -32600, -32042, -32600, -32601]


# -- JWT (tests/test_jwt.py on both packages) ----------------------------------


@PKGS
def test_jwt_roundtrip_and_rejections(P):
    jwt = P.jwt
    token = jwt.encode_jwt(SECRET, {"sub": "cl"})
    claims = jwt.validate_jwt(SECRET, token)
    assert claims["sub"] == "cl" and isinstance(claims["iat"], int)
    with pytest.raises(jwt.JwtError, match="signature"):
        jwt.validate_jwt(b"\x00" * 32, token)
    with pytest.raises(jwt.JwtError, match="malformed"):
        jwt.validate_jwt(SECRET, "nope")
    stale = jwt.encode_jwt(SECRET, {"iat": int(time.time()) - jwt.IAT_WINDOW - 10})
    with pytest.raises(jwt.JwtError, match="iat"):
        jwt.validate_jwt(SECRET, stale)
    h, p, s = token.split(".")
    with pytest.raises(jwt.JwtError):
        jwt.validate_jwt(SECRET, f"{h}.{p}x.{s}")


def test_jwt_tokens_cross_the_packages():
    assert RREF.jwt.IAT_WINDOW == RPORT.jwt.IAT_WINDOW
    for a, b in ((RREF, RPORT), (RPORT, RREF)):
        claims = b.jwt.validate_jwt(SECRET, a.jwt.encode_jwt(SECRET, {"sub": "x"}))
        assert claims["sub"] == "x"
    fixed = {"iat": 1_700_000_000, "sub": "cl"}
    # the same claims sign to the same token when iat is pinned
    assert RPORT.jwt.encode_jwt(SECRET, fixed) == RREF.jwt.encode_jwt(SECRET, fixed)


@PKGS
def test_secret_file_roundtrip(P, tmp_path):
    path = tmp_path / "jwt.hex"
    s1 = P.jwt.load_or_create_secret(path)
    assert len(s1) == 32 and P.jwt.load_or_create_secret(path) == s1
    assert oct(path.stat().st_mode & 0o777) == "0o600"
    path.write_text("0x" + "ab" * 32)
    assert P.jwt.load_or_create_secret(path) == b"\xab" * 32
    other = RREF if P is RPORT else RPORT
    assert other.jwt.load_or_create_secret(path) == b"\xab" * 32
    path.write_text("ab" * 8)
    with pytest.raises(P.jwt.JwtError, match="32 bytes"):
        P.jwt.load_or_create_secret(path)


@PKGS
def test_http_auth_enforcement(P):
    server = P.server.RpcServer(jwt_secret=SECRET)
    server.register_method("test_ping", lambda: "pong")
    port = server.start()
    try:
        status, body = http(port, request("test_ping"))
        assert status == 401 and "unauthorized" in json.loads(body)["error"]["message"]
        status, _ = http(port, request("test_ping"), P.jwt.encode_jwt(os.urandom(32)))
        assert status == 401
        status, body = http(port, request("test_ping"), P.jwt.encode_jwt(SECRET))
        assert status == 200 and json.loads(body)["result"] == "pong"
    finally:
        server.stop()
    open_server = P.server.RpcServer()
    open_server.register_method("test_ping", lambda: "pong")
    port = open_server.start()
    try:
        status, body = http(port, request("test_ping"))
        assert status == 200 and json.loads(body)["result"] == "pong"
    finally:
        open_server.stop()


def test_unauthorized_answers_match_reference():
    def sc(P):
        server = P.server.RpcServer(jwt_secret=SECRET)
        server.register_method("test_ping", lambda: "pong")
        port = server.start()
        try:
            return [http(port, request("test_ping"))[1],
                    http(port, request("test_ping"), "a.b.c")[1],
                    http(port, request("test_ping"), "nodots")[1]]
        finally:
            server.stop()

    both(sc)


# -- WS and IPC ----------------------------------------------------------------


def _ws_client(P, port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    key = base64.b64encode(os.urandom(16))
    sock.sendall(b"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                 b"Connection: Upgrade\r\nSec-WebSocket-Key: " + key +
                 b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    assert b"101" in resp.split(b"\r\n")[0]
    assert base64.b64encode(hashlib.sha1(key + P.ws._WS_GUID).digest()) in resp
    return sock


def _ws_send(sock, payload: bytes, opcode: int = 1) -> None:
    mask = os.urandom(4)
    n = len(payload)
    header = bytes([0x80 | opcode]) + (bytes([0x80 | n]) if n < 126
                                       else bytes([0x80 | 126]) + struct.pack(">H", n))
    sock.sendall(header + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))


def _ws_recv(sock) -> tuple[int, bytes]:
    head = sock.recv(2)
    if len(head) < 2:
        return -1, b""
    opcode, ln = head[0] & 0x0F, head[1] & 0x7F
    if ln == 126:
        (ln,) = struct.unpack(">H", sock.recv(2))
    buf = b""
    while len(buf) < ln:
        buf += sock.recv(ln - len(buf))
    return opcode, buf


def sc_ws(P):
    rpc = P.server.RpcServer()
    rpc.register_method("test_echo", lambda x: x + 1)
    ws = P.ws.WsRpcServer(rpc)
    port = ws.start()
    out = []
    try:
        sock = _ws_client(P, port)
        for i in (1, 41):
            _ws_send(sock, request("test_echo", i, rid=i))
            out.append(_ws_recv(sock)[1])
        _ws_send(sock, b"ping!", opcode=9)
        out.append(repr(_ws_recv(sock)).encode())
        _ws_send(sock, b"\x03\xe8", opcode=8)
        out.append(repr(_ws_recv(sock)).encode())
        sock.close()
    finally:
        ws.stop()
    return out


def test_ws_roundtrip_matches_reference():
    got = both(sc_ws)
    assert json.loads(got[1]) == {"jsonrpc": "2.0", "id": 41, "result": 42}


def sc_ipc(P, path):
    rpc = P.server.RpcServer()
    rpc.register_method("test_echo", lambda x: x + 1)
    server = P.ipc.IpcRpcServer(rpc, path)
    out = []
    sock_path = server.start()
    try:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(sock_path)
        for i in (1, 41):
            sock.sendall(request("test_echo", i, rid=i) + b"\n\n")
            buf = b""
            while not buf.endswith(b"\n"):
                buf += sock.recv(4096)
            out.append(buf)
        sock.close()
    finally:
        server.stop()
    out.append(repr(os.path.exists(sock_path)).encode())
    return out


def test_ipc_roundtrip_matches_reference(tmp_path):
    got = both(sc_ipc, tmp_path / "node.ipc")
    assert json.loads(got[1]) == {"jsonrpc": "2.0", "id": 41, "result": 42}
    assert got[2] == b"False"


# -- the gateway (tests/test_gateway.py, the cases that need no node) ----------


@PKGS
def test_classification(P):
    g = P.gateway
    assert g.classify("engine_newPayloadV4") == "engine"
    assert g.classify("eth_sendRawTransaction") == "tx"
    assert g.classify("debug_traceTransaction") == "debug"
    assert g.classify("trace_block") == "debug"
    assert g.classify("ots_getApiLevel") == "debug"
    assert g.classify("eth_call") == "read" and g.classify("net_version") == "read"
    assert g.classify("producer_status") == "engine"
    assert g.classify("txpool_content") == "read"
    for method in ("fleet_register", "fleet_drain", "fleet_status"):
        assert g.classify(method) == "engine"
    assert g.CLASSES == RREF.gateway.CLASSES
    assert g.DEFAULT_COALESCE == RREF.gateway.DEFAULT_COALESCE


def _deterministic_handler(executions, delay=0.003):
    def eth_call(*params):
        executions.append(threading.get_ident())
        time.sleep(delay)  # widens the in-flight window
        return {"data": "0x" + keccak256(json.dumps(params, sort_keys=True).encode()).hex()}
    return eth_call


@PKGS
def test_threaded_stress_coalesced_bit_identical(P):
    """8 client threads x duplicate reads: every gated response equals the
    ungated server's, the handler runs fewer times than the requests."""
    gw = make_gateway(P, head_supplier=lambda: b"head-1", cache_size=0)
    gated_execs, naive_execs = [], []
    gated = P.server.RpcServer(gateway=gw)
    gated.register_method("eth_call", _deterministic_handler(gated_execs))
    naive = P.server.RpcServer()
    naive.register_method("eth_call", _deterministic_handler(naive_execs))
    threads, rounds = 8, 10
    barrier = threading.Barrier(threads)
    results, errors = {}, []

    def client(t):
        try:
            for r in range(rounds):
                barrier.wait()
                params = [{"to": f"0x{r:040x}", "data": "0xdeadbeef"}, "latest"]
                results[(t, r)] = gated.handle(request("eth_call", *params, rid=42))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    for r in range(rounds):
        params = [{"to": f"0x{r:040x}", "data": "0xdeadbeef"}, "latest"]
        want = naive.handle(request("eth_call", *params, rid=42))
        assert all(results[(t, r)] == want for t in range(threads))
    total = threads * rounds
    assert len(gated_execs) < total
    assert gw.coalesce_factor() > 1.0
    assert gw.snapshot()["coalesced"] == total - len(gated_execs)


@PKGS
def test_coalesced_errors_fan_out(P):
    gw = make_gateway(P, cache_size=0)
    srv = P.server.RpcServer(gateway=gw)
    gate = threading.Event()

    def eth_call(*params):
        gate.wait(5)
        raise ValueError("boom")

    srv.register_method("eth_call", eth_call)
    outs = [None, None]

    def client(i):
        outs[i] = handle(srv, "eth_call", ["x"])

    ts = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    ts[0].start()
    time.sleep(0.05)
    ts[1].start()
    time.sleep(0.05)
    gate.set()
    for t in ts:
        t.join()
    assert all(out["error"]["message"].endswith("boom") for out in outs)


def sc_cache(P):
    head = {"h": b"h1"}
    gw = make_gateway(P, head_supplier=lambda: head["h"])
    srv = P.server.RpcServer(gateway=gw)
    execs = []
    srv.register_method("eth_getLogs", _deterministic_handler(execs, delay=0))
    srv.register_method("eth_sendRawTransaction", lambda *a: "0x00")
    out = [srv.handle(request("eth_getLogs", {"fromBlock": "0x1"})) for _ in range(2)]
    out.append(srv.handle(request("eth_getLogs", {"fromBlock": "0x2"})))
    head["h"] = b"h2"
    gw.on_head_change(chain=[])
    out.append(srv.handle(request("eth_getLogs", {"fromBlock": "0x1"})))
    out += [srv.handle(request("eth_sendRawTransaction", "0x01")) for _ in range(2)]
    lru = make_gateway(P, head_supplier=lambda: b"h", cache_size=2)
    srv2 = P.server.RpcServer(gateway=lru)
    execs2 = []
    srv2.register_method("eth_call", _deterministic_handler(execs2, delay=0))
    for k in ("k0", "k1", "k2", "k0"):
        out.append(srv2.handle(request("eth_call", k)))
    snap = {k: v for k, v in gw.snapshot().items() if "rate" not in k and "factor" not in k}
    out.append(json.dumps([len(execs), len(execs2), gw.cache_hits, gw.cache_misses,
                           gw.invalidations, sorted(snap)]).encode())
    return out


def test_cache_hits_head_invalidation_and_lru_match_reference():
    got = both(sc_cache)
    assert json.loads(got[-1])[:5] == [3, 4, 1, 3, 1]


@PKGS
def test_full_queue_sheds_without_wedging_other_classes(P):
    gw = make_gateway(P, class_limits={"read": 1}, queue_caps={"read": 1}, cache_size=0)
    srv = P.server.RpcServer(gateway=gw)
    gate = threading.Event()
    running = threading.Event()

    def slow():
        running.set()
        gate.wait(10)
        return "slow"

    srv.register_method("eth_slow", slow)
    srv.register_method("eth_fast", lambda: "fast")
    srv.register_method("engine_ping", lambda: "pong")
    outs = {}

    def call(name, method):
        outs[name] = handle(srv, method, [])

    t_run = threading.Thread(target=call, args=("running", "eth_slow"))
    t_run.start()
    assert running.wait(10)
    t_q = threading.Thread(target=call, args=("queued", "eth_fast"))
    t_q.start()
    for _ in range(1000):  # until the queued read waits for the slot
        if gw.snapshot()["waiting"]["read"] == 1:
            break
        time.sleep(0.005)
    shed = handle(srv, "eth_fast", [])
    assert shed["error"]["code"] == P.gateway.OVERLOADED
    assert shed["error"]["data"]["retry_after"] > 0 and shed["error"]["data"]["class"] == "read"
    assert handle(srv, "engine_ping", [])["result"] == "pong"
    assert gw.snapshot()["sheds"] == 1
    gate.set()
    t_run.join()
    t_q.join()
    assert outs["queued"]["result"] == "fast" and outs["running"]["result"] == "slow"


def sc_shed_drill(P):
    inj = P.gateway.GatewayFaultInjector(shed_every=3)
    gw = make_gateway(P, injector=inj, cache_size=0)
    srv = P.server.RpcServer(gateway=gw)
    srv.register_method("eth_ping", lambda: "pong")
    out = [srv.handle(request("eth_ping")) for _ in range(6)]
    env = {"RETH_TPU_FAULT_GATEWAY_STALL": "0.5", "RETH_TPU_FAULT_GATEWAY_SHED": "7"}
    from_env = P.gateway.GatewayFaultInjector.from_env(env)
    out.append(json.dumps([inj.forced_sheds, gw.snapshot()["fault_injection"],
                           from_env.stall, from_env.shed_every, from_env.active(),
                           P.gateway.GatewayFaultInjector.from_env({}) is None]).encode())
    return out


def test_fault_drill_shed_every_matches_reference():
    got = both(sc_shed_drill)
    codes = [json.loads(r).get("error", {}).get("code") for r in got[:6]]
    assert codes == [None, None, -32005, None, None, -32005]
    assert json.loads(got[-1]) == [2, True, 0.5, 7, True, True]


@PKGS
def test_http_ws_ipc_route_through_one_gateway(P, tmp_path):
    gw = make_gateway(P, head_supplier=lambda: b"h")
    srv = P.server.RpcServer(gateway=gw)
    execs = []
    srv.register_method("eth_call", _deterministic_handler(execs, delay=0))
    http_port = srv.start()
    ws = P.ws.WsRpcServer(srv)
    ws_port = ws.start()
    ipc = P.ipc.IpcRpcServer(srv, tmp_path / "node.ipc")
    ipc_path = ipc.start()
    body = request("eth_call", "parity")
    try:
        http_out = http(http_port, body)[1]
        wsock = _ws_client(P, ws_port)
        _ws_send(wsock, body)
        ws_out = _ws_recv(wsock)[1]
        wsock.close()
        isock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        isock.connect(ipc_path)
        isock.sendall(body + b"\n")
        ipc_out = b""
        while not ipc_out.endswith(b"\n"):
            ipc_out += isock.recv(4096)
        isock.close()
    finally:
        srv.stop()
        ws.stop()
        ipc.stop()
    assert http_out == ws_out == ipc_out.strip()
    assert len(execs) == 1 and gw.requests == 3 and gw.cache_hits == 2


# -- /metrics, and what is not ported yet ---------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_metrics_endpoint_and_absent_routes():
    srv = RPORT.server.RpcServer()
    port = srv.start()
    try:
        status, body = _get(port, "/metrics")
        fleet_status, fleet_body = _get(port, "/metrics?scope=fleet")
        health = _get(port, "/health")[0]
        other = _get(port, "/nope")[0]
    finally:
        srv.stop()
    text = body.decode()
    assert status == 200 and fleet_status == 200
    for name in ("process_uptime_seconds", "process_resident_memory_bytes",
                 "process_threads", "reth_tpu_build_info"):
        assert name in text
    assert 'torch="' in text and "jax" not in text
    assert "process_uptime_seconds" in fleet_body.decode()
    assert health == 404 and other == 404


ABSENT = ("debug_healthCheck", "debug_sloStatus", "debug_metricsHistory",
          "debug_fleetMetrics", "fleet_status")


def sc_absent(P):
    b, _w = wallets_builder(P)
    with RpcNode(P, b) as n:
        served = sorted(set(n.rpc.methods) | set(n.authrpc.methods))
        out = [n.call(m) for m in ABSENT]
        out.append(n.call("debug_flightRecorder", "correlated"))
        out.append(n.call("debug_flightRecorder", "bogus"))
        return out, served


def test_absent_methods_are_not_served():
    """The port serves every method the reference's node wires but the health,
    SLO and fleet ones (admin_* is served where the node has a network:
    test_admin_methods_over_the_network)."""
    (ref_out, ref_served), (port_out, port_served) = sc_absent(RREF), sc_absent(RPORT)
    for raw in port_out[:len(ABSENT)]:
        assert json.loads(raw)["error"]["code"] == -32601
    assert set(ref_served) - set(port_served) == {
        "debug_healthCheck", "debug_sloStatus", "debug_metricsHistory", "debug_fleetMetrics"}
    assert set(port_served) <= set(ref_served)
    correlated = json.loads(port_out[-2])["error"]
    assert correlated["code"] == -32602 and "correlated" in correlated["message"]
    assert "correlated" not in json.loads(ref_out[-2]).get("error", {}).get("message", "")
    assert json.loads(port_out[-1])["error"]["code"] == json.loads(ref_out[-1])["error"]["code"]


def sc_admin(P):
    """admin_* through the public server of a node with a network (fixed node
    keys): nodeInfo, then peers before and after a second manager dials in,
    addPeer / removePeer of a third, a malformed enode. Listening ports are
    ephemeral, so they are masked."""
    b, _w = wallets_builder(P)
    status = P.wire.Status(network_id=1, head=b.genesis.hash, genesis=b.genesis.hash)
    kw = {"device": "cpu"} if P is RPORT else {}
    store = (JMemDb, JFactory) if P is RREF else (PMemDb, PFactory)
    nets = [P.netserver.NetworkManager(store[1](store[0]()), status, node_priv=key, **kw)
            for key in (0xAD1, 0xAD2, 0xAD3)]
    ports = [n.start() for n in nets]

    def mask(raw: bytes) -> bytes:
        for i, port in enumerate(ports):
            raw = raw.replace(f":{port}".encode(), f":P{i}".encode()).replace(
                f'"listener": {port}'.encode(), f'"listener": "P{i}"'.encode())
        return raw

    try:
        with RpcNode(P, b, network=nets[0]) as n:
            out = [n.call("admin_nodeInfo"), n.call("admin_peers")]
            peer = nets[1].connect_to(nets[0].enode)
            deadline = time.monotonic() + 10
            while not nets[0].peers and time.monotonic() < deadline:
                time.sleep(0.02)
            out.append(n.call("admin_peers"))
            peer.close()
            deadline = time.monotonic() + 10
            while nets[0].peers and time.monotonic() < deadline:
                time.sleep(0.02)
            out.append(n.call("admin_addPeer", nets[2].enode))
            out.append(str(len(nets[0].peers)).encode())
            out.append(n.call("admin_removePeer", nets[2].enode))
            out.append(n.call("admin_addPeer", "enode://zz@nope"))
            return [mask(raw) for raw in out]
    finally:
        for net in nets:
            net.stop()


def test_admin_methods_over_the_network():
    """admin_nodeInfo and admin_peers are the reference's JSON byte for byte
    with the same node keys; addPeer / removePeer move the peer set alike."""
    got = both(sc_admin)
    info = json.loads(got[0])["result"]
    assert info["enode"].startswith("enode://") and info["ports"]["listener"] == "P0"
    assert json.loads(got[1])["result"] == []
    assert len(json.loads(got[2])["result"]) == 1
    assert [json.loads(r)["result"] for r in got[3:] if r.startswith(b"{")] == [
        True, True, False]
    assert got[4] == b"1"


# -- the departure: a kernel fault under handle() --------------------------------


def _faulty_server(**kw):
    srv = RPORT.server.RpcServer(**kw)
    srv.register_method("test_ok", lambda: "ok")

    def launch():
        raise LaunchError("keccak256_absorb: an illegal memory access was encountered")

    def chained():
        try:
            raise RuntimeError("CUDA error: device-side assert triggered")
        except RuntimeError as e:
            raise ValueError("wrapped") from e

    srv.register_method("test_launch", launch)
    srv.register_method("test_chained", chained)
    srv.register_method("test_plain", lambda: (_ for _ in ()).throw(ValueError("no card")))
    return srv


def test_kernel_fault_reraises_out_of_handle_and_is_counted():
    srv = _faulty_server()
    with pytest.raises(LaunchError):
        srv.handle(request("test_launch"))
    with pytest.raises(ValueError, match="wrapped"):
        srv.handle(request("test_chained"))
    batch = json.dumps([json.loads(request("test_ok")),
                        json.loads(request("test_launch", rid=2))]).encode()
    with pytest.raises(LaunchError):
        srv.handle(batch)
    assert srv.kernel_faults == 3 and srv.kernel_fault is None
    plain = json.loads(srv.handle(request("test_plain")))
    assert plain["error"]["code"] == -32603 and srv.kernel_faults == 3
    # the reference maps the same fault to -32603
    ref = RREF.server.RpcServer()
    ref.register_method("test_launch", lambda: (_ for _ in ()).throw(LaunchError("x")))
    assert json.loads(ref.handle(request("test_launch")))["error"]["code"] == -32603


def test_kernel_fault_through_the_gateway_reraises():
    gw = make_gateway(RPORT, head_supplier=lambda: b"h")
    srv = _faulty_server(gateway=gw)
    srv.register_method("eth_call", lambda *a: (_ for _ in ()).throw(LaunchError("x")))
    with pytest.raises(LaunchError):
        srv.handle(request("eth_call", "k"))
    with pytest.raises(LaunchError):
        srv.handle(request("test_launch"))
    assert srv.kernel_faults == 2 and gw.cache_hits == 0


def test_kernel_fault_at_each_transport_edge(tmp_path):
    """HTTP answers 500, WS and IPC close the connection; each keeps the
    first fault on the server and sends no result; the server goes on."""
    srv = _faulty_server()
    port = srv.start()
    ws = RPORT.ws.WsRpcServer(srv)
    ws_port = ws.start()
    ipc = RPORT.ipc.IpcRpcServer(srv, tmp_path / "node.ipc")
    ipc_path = ipc.start()
    try:
        status, body = http(port, request("test_launch"))
        assert status == 500 and body == b""
        first = srv.kernel_fault
        assert isinstance(first, LaunchError)
        assert json.loads(http(port, request("test_ok"))[1])["result"] == "ok"
        sock = _ws_client(RPORT, ws_port)
        _ws_send(sock, request("test_chained"))
        assert _ws_recv(sock) == (-1, b"")
        sock.close()
        isock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        isock.connect(ipc_path)
        isock.sendall(request("test_launch") + b"\n")
        assert isock.recv(4096) == b""
        isock.close()
        assert srv.kernel_faults == 3 and srv.kernel_fault is first
    finally:
        srv.stop()
        ws.stop()
        ipc.stop()
