"""Both packages' node, CLI and node-side helpers side by side, for
tests/test_torch_cli.py, test_torch_node.py and test_torch_node_aux.py.

``NREF`` and ``NPORT`` name the same modules of the JAX package and of the
port. The reference runs on its host numpy committer
(``TrieCommitter(hasher=keccak256_batch_np)``, ``--hasher cpu``); the port
runs on ``device="cpu"`` (``--device cpu``): its card route with every
kernel's plain version. ``P.node(cfg)`` builds P's ``Node`` that way, and
``P.argv`` is what P's CLI is given on every subcommand that builds a
committer. Inputs are the reference's: chains sealed by its ``ChainBuilder``
on numpy and transactions signed by its ``Wallet``, carried across by their
RLP (``P.tx``, ``P.header``) and an alloc by its plain fields
(``P.alloc``).

A scenario is one function of such a namespace that returns what it
observed; a test runs it on both and holds the two equal (``both``),
tolerance zero. Payload ids are random in both packages, and paths differ,
so ``mask`` takes both out of what is compared.
"""

from __future__ import annotations

import json
import re
import types
import urllib.error
import urllib.request

from reth_tpu import cli as jcli
from reth_tpu import ethstats as jethstats
from reth_tpu import events as jevents
from reth_tpu import exex as jexex
from reth_tpu import prune as jprune
from reth_tpu import tasks as jtasks
from reth_tpu import testing as jtesting
from reth_tpu import tracing as jtracing
from reth_tpu.node import Node as JNode
from reth_tpu.node import NodeConfig as JNodeConfig
from reth_tpu.node import events as jnode_events
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import types as jtypes
from reth_tpu.rpc import jwt as jjwt
from reth_tpu.rpc import ws as jws
from reth_tpu import storage as jstorage
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.storage import native as jnative
from reth_tpu.storage import open_database as jopen_database
from reth_tpu.storage import tables as jtables
from reth_tpu.trie.committer import BranchNode as JBranchNode
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch import cli as pcli
from reth_tpu_torch import convert as pconvert
from reth_tpu_torch import ethstats as pethstats
from reth_tpu_torch import events as pevents
from reth_tpu_torch import exex as pexex
from reth_tpu_torch import prune as pprune
from reth_tpu_torch import tasks as ptasks
from reth_tpu_torch import tracing as ptracing
from reth_tpu_torch.node import Node as PNode
from reth_tpu_torch.node import NodeConfig as PNodeConfig
from reth_tpu_torch.node import events as pnode_events
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.rpc import jwt as pjwt
from reth_tpu_torch.rpc import ws as pws
from reth_tpu_torch import storage as pstorage
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.storage import native as pnative
from reth_tpu_torch.storage import open_database as popen_database
from reth_tpu_torch.storage import tables as ptables
from reth_tpu_torch.trie.committer import BranchNode as PBranchNode

__all__ = ["NREF", "NPORT", "both", "mask", "http", "request", "result", "ALICE",
           "ref_committer", "store_tables", "Wallet", "ChainBuilder", "Account"]

ALICE = 0xA11CE
Wallet = jtesting.Wallet
ChainBuilder = jtesting.ChainBuilder
Account = jtypes.Account


def ref_committer():
    return JCommitter(hasher=jkeccak.keccak256_batch_np)


def _port_alloc(accounts: dict, storage: dict | None = None, codes: dict | None = None):
    fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                      code=(codes or {}).get(acc.code_hash, b""),
                      storage=(storage or {}).get(a, {}))
              for a, acc in accounts.items()}
    return pconvert.alloc_from_fields(fields)[0]


NREF = types.SimpleNamespace(
    name="reference", cli=jcli, Node=JNode, NodeConfig=JNodeConfig, types=jtypes,
    tasks=jtasks, events=jevents, exex=jexex, ethstats=jethstats, tracing=jtracing,
    node_events=jnode_events, ws=jws, jwt=jjwt, prune=jprune, tables=jtables,
    open_database=jopen_database, storage=jstorage, native=jnative, genesis=jgenesis,
    BranchNode=JBranchNode, argv=["--hasher", "cpu"],
    node=lambda cfg: JNode(cfg, committer=ref_committer()),
    tx=lambda t: t, header=lambda h: h, alloc=lambda accounts: dict(accounts),
)
NPORT = types.SimpleNamespace(
    name="port", cli=pcli, Node=PNode, NodeConfig=PNodeConfig, types=ptypes,
    tasks=ptasks, events=pevents, exex=pexex, ethstats=pethstats, tracing=ptracing,
    node_events=pnode_events, ws=pws, jwt=pjwt, prune=pprune, tables=ptables,
    open_database=popen_database, storage=pstorage, native=pnative, genesis=pgenesis,
    BranchNode=PBranchNode, argv=["--device", "cpu"],
    node=lambda cfg: PNode(cfg, device="cpu"),
    tx=lambda t: ptypes.Transaction.decode(t.encode()),
    header=lambda h: ptypes.Header.decode(h.encode()),
    alloc=_port_alloc,
)


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


_PAYLOAD_ID = re.compile(rb'"payloadId": ?"0x[0-9a-f]+"')


def mask(obs, paths=()):
    """``obs`` with payload ids and the given paths replaced by fixed marks,
    recursively through lists, tuples and dicts."""
    if isinstance(obs, bytes):
        obs = _PAYLOAD_ID.sub(b'"payloadId": "<id>"', obs)
        for i, p in enumerate(paths):
            obs = obs.replace(str(p).encode(), f"<path{i}>".encode())
        return obs
    if isinstance(obs, str):
        for i, p in enumerate(paths):
            obs = obs.replace(str(p), f"<path{i}>")
        return re.sub(r'"payloadId": ?"0x[0-9a-f]+"', '"payloadId": "<id>"', obs)
    if isinstance(obs, (list, tuple)):
        return type(obs)(mask(o, paths) for o in obs)
    if isinstance(obs, dict):
        return {k: mask(v, paths) for k, v in obs.items()}
    return obs


def both(scenario, *args, paths=lambda P: ()):
    """The scenario's observations on the reference and on the port, masked
    (``paths(P)``: each side's own paths) and held equal; returns the
    port's."""
    want = mask(scenario(NREF, *args), paths(NREF))
    got = mask(scenario(NPORT, *args), paths(NPORT))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"observation {i} differs:\n port {g!r}\n  ref {w!r}"
    return got


def store_tables(P, backend: str, datadir) -> dict:
    """Every table of P's store in ``datadir``: name -> [(key, dups)] in key
    order (a DUPSORT table's values as their sorted set)."""
    db = P.open_database(backend, datadir)
    names = sorted(v.name for v in vars(P.tables.Tables).values()
                   if isinstance(v, P.tables.TableDef))
    out = {}
    with db.tx() as tx:
        for name in names:
            rows = []
            cur = tx.cursor(name)
            entry = cur.first()
            while entry is not None:
                rows.append((entry[0], tuple(tx.get_dups(name, entry[0]))))
                entry = cur.next_no_dup()
            out[name] = rows
    close = getattr(db, "close", None)
    if close is not None:
        close()
    return out
