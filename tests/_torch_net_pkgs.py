"""Both packages' networking, online stages and era archives side by side, for
tests/test_torch_net.py, test_torch_snap.py, test_torch_era.py and
test_torch_discovery.py.

``NREF`` and ``NPORT`` name the same modules of the JAX package and of the
port. ``P.kw`` holds what a port entry point needs to stay on the CPU
(``device="cpu"``; empty for the reference), and ``P.committer()`` is the
reference's numpy committer or the port's card route on the CPU
(``TrieCommitter(device="cpu")``: kernel 1's plain version for every hash);
``P.np()`` is P's numpy committer, which builds the fixtures. ``synced(P)``
builds a chain with P's own ``ChainBuilder`` and syncs a database to its
tip; the two packages' chains are equal block for block.
A scenario is one function of such a namespace; a test runs it on both and
holds what it returns equal, tolerance zero.
"""

from __future__ import annotations

import types

from reth_tpu import era as jera
from reth_tpu import era_sync as jera_sync
from reth_tpu import testing as jtesting
from reth_tpu.consensus import EthBeaconConsensus as JConsensus
from reth_tpu.net import discv4 as jdiscv4
from reth_tpu.net import discv5 as jdiscv5
from reth_tpu.net import dnsdisc as jdnsdisc
from reth_tpu.net import downloader as jdownloader
from reth_tpu.net import ecies as jecies
from reth_tpu.net import enr as jenr
from reth_tpu.net import p2p as jp2p
from reth_tpu.net import reputation as jreputation
from reth_tpu.net import rlpx as jrlpx
from reth_tpu.net import server as jserver
from reth_tpu.net import snap as jsnap
from reth_tpu.net import snappy as jsnappy
from reth_tpu.net import wire as jwire
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu.rpc import admin as jadmin
from reth_tpu.stages import Pipeline as JPipeline
from reth_tpu.stages import api as japi
from reth_tpu.stages import default_stages as jdefault_stages
from reth_tpu.stages import online_stages as jonline_stages
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch import era as pera
from reth_tpu_torch import era_sync as pera_sync
from reth_tpu_torch import testing as ptesting
from reth_tpu_torch.consensus import EthBeaconConsensus
from reth_tpu_torch.net import discv4 as pdiscv4
from reth_tpu_torch.net import discv5 as pdiscv5
from reth_tpu_torch.net import dnsdisc as pdnsdisc
from reth_tpu_torch.net import downloader as pdownloader
from reth_tpu_torch.net import ecies as pecies
from reth_tpu_torch.net import enr as penr
from reth_tpu_torch.net import p2p as pp2p
from reth_tpu_torch.net import reputation as preputation
from reth_tpu_torch.net import rlpx as prlpx
from reth_tpu_torch.net import server as pserver
from reth_tpu_torch.net import snap as psnap
from reth_tpu_torch.net import snappy as psnappy
from reth_tpu_torch.net import wire as pwire
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import secp256k1 as psecp
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.rpc import admin as padmin
from reth_tpu_torch.stages import Pipeline
from reth_tpu_torch.stages import api as papi
from reth_tpu_torch.stages import default_stages, online_stages
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.trie.committer import TrieCommitter

__all__ = ["NREF", "NPORT", "builder", "synced", "fresh", "tables", "ALICE", "SINK"]

ALICE = 0xA11CE
SINK = b"\x0b" * 20


def _ns(kw: dict, **mods) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(kw=kw, **mods)
    ns.Status = mods["wire"].Status
    ns.NetworkManager = mods["server"].NetworkManager
    ns.PeerConnection = mods["p2p"].PeerConnection
    ns.PeerError = mods["p2p"].PeerError
    ns.Account = mods["types"].Account
    ns.Wallet = mods["testing"].Wallet
    ns.consensus = lambda np=False: ns.Consensus(ns.np() if np else ns.committer(), **kw)
    ns.stages = lambda np=False: ns.default_stages(
        committer=ns.np() if np else ns.committer(), consensus=ns.consensus(np), **kw)
    ns.pub = mods["secp"].pubkey_from_priv
    return ns


NREF = _ns(
    {}, name="reference", wire=jwire, snap=jsnap, snappy=jsnappy, rlpx=jrlpx, ecies=jecies,
    p2p=jp2p, server=jserver, downloader=jdownloader, reputation=jreputation,
    discv4=jdiscv4, discv5=jdiscv5, enr=jenr, dnsdisc=jdnsdisc, era=jera,
    era_sync=jera_sync, admin=jadmin, types=jtypes, keccak=jkeccak, secp=jsecp,
    testing=jtesting, Consensus=JConsensus, Pipeline=JPipeline, api=japi,
    default_stages=jdefault_stages, online_stages=jonline_stages, MemDb=JMemDb,
    Factory=JFactory, genesis=jgenesis,
    committer=lambda: JCommitter(hasher=jkeccak.keccak256_batch_np),
    np=lambda: JCommitter(hasher=jkeccak.keccak256_batch_np),
)

NPORT = _ns(
    {"device": "cpu"}, name="port", wire=pwire, snap=psnap, snappy=psnappy, rlpx=prlpx,
    ecies=pecies, p2p=pp2p, server=pserver, downloader=pdownloader,
    reputation=preputation, discv4=pdiscv4, discv5=pdiscv5, enr=penr, dnsdisc=pdnsdisc,
    era=pera, era_sync=pera_sync, admin=padmin, types=ptypes, keccak=pkeccak,
    secp=psecp, testing=ptesting, Consensus=EthBeaconConsensus, Pipeline=Pipeline,
    api=papi, default_stages=default_stages, online_stages=online_stages, MemDb=MemDb,
    Factory=ProviderFactory, genesis=pgenesis,
    committer=lambda: TrieCommitter(device="cpu"),
    np=lambda: TrieCommitter(hasher=pkeccak.keccak256_batch_np, device="cpu"),
)


def builder(P, n_blocks: int = 8, codes: dict | None = None, extra: dict | None = None,
            wallet: int = ALICE, to: bytes = SINK, storage: dict | None = None):
    """P's ``ChainBuilder`` over a funded wallet (and ``extra`` genesis
    accounts, ``storage`` and ``codes``), ``n_blocks`` blocks of one transfer
    each."""
    w = P.Wallet(wallet)
    alloc = {w.address: P.Account(balance=10**21), **(extra or {})}
    b = P.testing.ChainBuilder(alloc, genesis_storage=storage, committer=P.np(), codes=codes,
                               **P.kw)
    for i in range(n_blocks):
        b.build_block([w.transfer(to, 100 + i)])
    return b


def fresh(P, b):
    """A database of P at ``b``'s genesis."""
    f = P.Factory(P.MemDb())
    P.genesis.init_genesis(f, b.genesis, b.accounts_at_genesis, storage=b.storage_at_genesis,
                           codes=b.codes_at_genesis, committer=P.np(), **P.kw)
    return f


def synced(P, n_blocks: int = 8, **kw):
    """(factory, builder): P's database synced to the builder's tip by import
    and the offline stages (``kw``: ``builder``'s)."""
    b = builder(P, n_blocks, **kw)
    f = fresh(P, b)
    P.genesis.import_chain(f, b.blocks[1:], P.consensus(np=True))
    P.Pipeline(f, P.stages(np=True)).run(n_blocks)
    return f, b


def tables(factory, skip=()) -> dict:
    """Every non-empty table of a ``MemDb`` factory, row for row."""
    return {name: dict(rows) for name, rows in factory.db._tables.items()
            if rows and name not in skip}
