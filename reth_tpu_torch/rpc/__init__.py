"""JSON-RPC: eth/net/web3/txpool namespaces + the Engine API.

A copy of the JAX package's ``rpc/`` on the port's engine tree, pool, payload
service and proofs: every method's JSON is the reference's. Their roots hash
on the tree's committer, on the card by default (kernel 1; kernel 4 through
the tree's hot-state arena on ``engine_newPayload``). ``rpc/admin.py``
serves ``admin_*`` over the port's ``net/``. Not ported yet: ``/health``
and the health, SLO and fleet methods of ``debug_*``.

Reference analogue: crates/rpc — the jsonrpsee module registry
(rpc-builder), the eth API trait stack (rpc-eth-api), and the Engine API
server (rpc-engine-api/src/engine_api.rs). Transport here is a stdlib
threaded HTTP server (no external deps); module selection mirrors
`RethRpcModule` names.
"""

from .server import RpcServer, RpcError
from .eth import EthApi
from .engine_api import EngineApi

__all__ = ["RpcServer", "RpcError", "EthApi", "EngineApi"]
