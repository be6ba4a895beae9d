"""Both packages' JSON-RPC servers wired side by side, for
tests/test_torch_rpc_server.py, test_torch_rpc_eth.py, test_torch_rpc_engine.py
and test_torch_rpc_debug.py.

``RpcNode(P, builder)`` wires one package's servers the way the JAX package's
``node/node.py`` does (:496-559), without its ``Node``: the engine tree, the
pool with its batcher and its canonical-state maintenance, the payload
service, the dev-mode miner, one shared lock, the public server (eth, net,
web3, txpool, debug, otterscan, flashbots, miner) and the auth server
(engine, eth), the latter with an optional JWT secret; given a
``network``, the public server also serves ``admin_*`` (the node's
``enable_admin``). ``P``
is a namespace of ``tests/_torch_block_pkgs.py`` (``REF``, ``PORT``,
``PORT_CARD``) with the package's ``rpc/`` modules added (``RREF``,
``RPORT``, ``RPORT_CARD``); its genesis is the reference ``ChainBuilder``'s,
carried across by plain fields.

A scenario is one function of such a namespace that returns the raw response
bytes of the calls it made (``RpcNode.call``: one request through
``RpcServer.handle``; ``http`` over the wire). A test runs it on the
reference and on the port and holds the bytes equal (``both``), tolerance
zero. Payload ids are random in both packages, so scenarios keep them out of
what they return.
"""

from __future__ import annotations

import json
import threading
import types
import urllib.error
import urllib.request

from _torch_block_pkgs import PORT, PORT_CARD, REF, Account, ChainBuilder, Wallet, genesis_factory
from reth_tpu.consensus import debug_client as jdebug_client
from reth_tpu.consensus import validation as jvalidation
from reth_tpu.net import server as jnetserver
from reth_tpu.net import wire as jwire
from reth_tpu.rpc import admin as jadmin
from reth_tpu.rpc import convert as jconvert
from reth_tpu.rpc import debug as jdebug
from reth_tpu.rpc import engine_api as jengine_api
from reth_tpu.rpc import eth as jeth
from reth_tpu.rpc import flashbots as jflashbots
from reth_tpu.rpc import gateway as jgateway
from reth_tpu.rpc import ipc as jipc
from reth_tpu.rpc import jwt as jjwt
from reth_tpu.rpc import miner as jminer
from reth_tpu.rpc import net as jnet
from reth_tpu.rpc import otterscan as jotterscan
from reth_tpu.rpc import server as jserver
from reth_tpu.rpc import ws as jws
from reth_tpu.trie import proof as jproof
from reth_tpu_torch.consensus import debug_client as pdebug_client
from reth_tpu_torch.consensus import validation as pvalidation
from reth_tpu_torch.net import server as pnetserver
from reth_tpu_torch.net import wire as pwire
from reth_tpu_torch.rpc import admin as padmin
from reth_tpu_torch.rpc import convert as pconvert
from reth_tpu_torch.rpc import debug as pdebug
from reth_tpu_torch.rpc import engine_api as pengine_api
from reth_tpu_torch.rpc import eth as peth
from reth_tpu_torch.rpc import flashbots as pflashbots
from reth_tpu_torch.rpc import gateway as pgateway
from reth_tpu_torch.rpc import ipc as pipc
from reth_tpu_torch.rpc import jwt as pjwt
from reth_tpu_torch.rpc import miner as pminer
from reth_tpu_torch.rpc import net as pnet
from reth_tpu_torch.rpc import otterscan as potterscan
from reth_tpu_torch.rpc import server as pserver
from reth_tpu_torch.rpc import ws as pws
from reth_tpu_torch.trie import proof as pproof

__all__ = ["RREF", "RPORT", "RPORT_CARD", "RpcNode", "both", "http", "Account",
           "ChainBuilder", "Wallet", "ALICE", "BOB", "SINK"]

ALICE = 0xA11CE
BOB = 0xB0B
SINK = b"\x0b" * 20


def _with_rpc(P, **mods):
    ns = types.SimpleNamespace(**vars(P))
    for k, v in mods.items():
        setattr(ns, k, v)
    return ns


_JRPC = dict(server=jserver, convert=jconvert, eth=jeth, engine_api=jengine_api,
             debug=jdebug, flashbots=jflashbots, miner=jminer, net=jnet,
             otterscan=jotterscan, gateway=jgateway, ws=jws, ipc=jipc, jwt=jjwt,
             debug_client=jdebug_client, validation=jvalidation, proof=jproof,
             admin=jadmin, netserver=jnetserver, wire=jwire)
_PRPC = dict(server=pserver, convert=pconvert, eth=peth, engine_api=pengine_api,
             debug=pdebug, flashbots=pflashbots, miner=pminer, net=pnet,
             otterscan=potterscan, gateway=pgateway, ws=pws, ipc=pipc, jwt=pjwt,
             debug_client=pdebug_client, validation=pvalidation, proof=pproof,
             admin=padmin, netserver=pnetserver, wire=pwire)

RREF = _with_rpc(REF, **_JRPC)
RPORT = _with_rpc(PORT, **_PRPC)
RPORT_CARD = _with_rpc(PORT_CARD, **_PRPC)


def request(method: str, *params, rid=1) -> bytes:
    return json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": list(params)}).encode()


def http(port: int, body: bytes, token: str | None = None) -> tuple[int, bytes]:
    """One POST to 127.0.0.1:``port``: (status, body)."""
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", body, headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def result(raw: bytes):
    out = json.loads(raw)
    if "error" in out:
        raise RuntimeError(out["error"])
    return out["result"]


class RpcNode:
    """One package's node surfaces, wired as ``node.py:496-559`` wires them."""

    def __init__(self, P, builder, *, chain_id: int = 1, jwt_secret: bytes | None = None,
                 persistence_threshold: int = 2, network=None, discovery=None, **tree_kw):
        self.P = P
        self.builder = builder
        self.factory = genesis_factory(P, builder)
        self.tree = P.tree(self.factory, persistence_threshold=persistence_threshold,
                           **tree_kw)
        self.pool = P.TransactionPool(lambda: self.tree.overlay_provider(),
                                      P.PoolConfig(chain_id=chain_id))
        self.tx_batcher = P.TxBatcher(self.pool)
        with self.factory.provider() as p:
            tip = p.header_by_number(p.last_block_number())
        if tip.base_fee_per_gas is not None:
            self.pool.base_fee = tip.base_fee_per_gas
        self.payload_service = P.PayloadBuilderService(self.tree, self.pool)
        self.miner = P.LocalMiner(self.tree, self.pool)

        def maintain_pool(chain):
            if chain:
                head = chain[-1].block.header
                self.pool.on_canonical_state_change(P.validation.calc_next_base_fee(head))

        self.tree.canon_listeners.append(maintain_pool)
        self.lock = threading.RLock()
        self.payload_service.lock = self.lock
        self.eth_api = P.eth.EthApi(self.tree, self.pool, chain_id, tx_batcher=self.tx_batcher)
        self.rpc = P.server.RpcServer(lock=self.lock)
        self.rpc.register(self.eth_api)
        self.rpc.register(P.net.NetApi(chain_id))
        self.rpc.register(P.net.Web3Api())
        self.rpc.register(P.net.TxpoolApi(self.pool))
        self.debug_api = P.debug.DebugApi(self.eth_api)
        self.rpc.register(self.debug_api)
        self.rpc.register(P.otterscan.OtterscanApi(self.eth_api, self.debug_api))
        self.rpc.register(P.flashbots.BundleApi(self.eth_api))
        self.rpc.register(P.flashbots.ValidationApi(self.eth_api))
        self.rpc.register(P.miner.MinerApi(self.payload_service, self.pool))
        if network is not None:  # the node's enable_admin (node.py:645-666)
            self.rpc.register(P.admin.AdminApi(network, discovery, chain_id))
        self.engine_api = P.engine_api.EngineApi(self.tree, self.payload_service,
                                                 pool=self.pool)
        self.authrpc = P.server.RpcServer(lock=self.lock, jwt_secret=jwt_secret)
        self.authrpc.register(self.engine_api)
        self.authrpc.register(self.eth_api)
        self.started = False

    def call(self, method: str, *params, server=None) -> bytes:
        """One request through ``handle`` (the dispatch every transport takes)."""
        return (server or self.rpc).handle(request(method, *params))

    def auth(self, method: str, *params) -> bytes:
        return self.call(method, *params, server=self.authrpc)

    def send(self, tx) -> bytes:
        return self.call("eth_sendRawTransaction", "0x" + tx.encode().hex())

    def start(self) -> tuple[int, int]:
        self.started = True
        return self.rpc.start(), self.authrpc.start()

    def stop(self) -> None:
        self.tx_batcher.close()
        if self.started:
            self.rpc.stop()
            self.authrpc.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def wallets_builder(P, n: int = 2, cancun: bool = False):
    """alice and bob, funded at genesis (a ChainBuilder of the reference's)."""
    ws = [Wallet(ALICE), Wallet(BOB)] + [Wallet(0x7F000 + i) for i in range(n - 2)]
    alloc = {w.address: Account(balance=10**21) for w in ws}
    return ChainBuilder(alloc, committer=REF.committer(), cancun=cancun), ws


def both(scenario, *args, port=RPORT):
    """The scenario's responses on the reference and on the port, held equal
    byte for byte; returns the port's."""
    want = scenario(RREF, *args)
    got = scenario(port, *args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"response {i} differs:\n port {g!r}\n  ref {w!r}"
    return got
