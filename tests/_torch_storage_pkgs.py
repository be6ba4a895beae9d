"""Both packages' storage surfaces side by side, for tests/test_torch_wal.py,
test_torch_native_kv.py and test_torch_storage_v2.py.

A scenario is one function of a package namespace (``REF`` or ``PORT``) and
a directory of its own; it returns what it observed (replay reports, WAL
snapshots, recovered tables, recovery reports). ``both`` runs it on the
reference and on the port, each in its own subdirectory, and holds the two
observations equal after ``scrub``: absolute paths become relative to the
scenario's directory, and the wall times (``wall_s``) go. The port's
recovery reports carry ``fallbacks`` (the failures its catch-alls counted),
which the reference's do not: ``scrub`` checks it is empty and drops it.

Chains are sealed by the reference's ``ChainBuilder`` and carried across by
their RLP and plain fields (``_torch_block_pkgs``). The port's committers
hash on numpy on the CPU (``np_committer``), or take the card route's plain
versions (``TrieCommitter(device="cpu")``) where a test says so.
"""

from __future__ import annotations

import types
from pathlib import Path

import reth_tpu.chaos as jchaos
import reth_tpu.metrics as jmetrics
import reth_tpu.prune as jprune
import reth_tpu.storage as jstorage
import reth_tpu.storage.historical as jhistorical
import reth_tpu.storage.kv as jkv
import reth_tpu.storage.native as jnative
import reth_tpu.storage.nippyjar as jnippyjar
import reth_tpu.storage.recovery as jrecovery
import reth_tpu.storage.settings as jsettings
import reth_tpu.storage.static_files as jstatic
import reth_tpu.storage.tables as jtables
import reth_tpu.storage.wal as jwal
import reth_tpu_torch.chaos as pchaos
import reth_tpu_torch.metrics as pmetrics
import reth_tpu_torch.prune as pprune
import reth_tpu_torch.storage as pstorage
import reth_tpu_torch.storage.historical as phistorical
import reth_tpu_torch.storage.kv as pkv
import reth_tpu_torch.storage.native as pnative
import reth_tpu_torch.storage.nippyjar as pnippyjar
import reth_tpu_torch.storage.recovery as precovery
import reth_tpu_torch.storage.settings as psettings
import reth_tpu_torch.storage.static_files as pstatic
import reth_tpu_torch.storage.tables as ptables
import reth_tpu_torch.storage.wal as pwal
from _torch_block_pkgs import PORT as BPORT
from _torch_block_pkgs import REF as BREF
from _torch_block_pkgs import np_committer, ref_committer
from reth_tpu import testing as jtesting
from reth_tpu.primitives import types as jtypes
from reth_tpu_torch import convert
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu.storage import genesis as jgenesis

Wallet = jtesting.Wallet
ChainBuilder = jtesting.ChainBuilder
Account = jtypes.Account


def _port_recover(factory, committer=None, **kw):
    kw.setdefault("device", "cpu")
    return precovery.recover_on_startup(factory, committer=committer or np_committer(), **kw)


def _ref_recover(factory, committer=None, **kw):
    return jrecovery.recover_on_startup(factory, committer=committer or ref_committer(), **kw)


def _ns(blocks, **kw):
    ns = types.SimpleNamespace(**kw)
    ns.MemDb = ns.kv.MemDb
    ns.ProviderFactory = ns.storage.ProviderFactory
    ns.Tables = ns.tables.Tables
    ns.attach_wal = ns.wal.attach_wal
    ns.UNWIND_MARKER_KEY = ns.recovery.UNWIND_MARKER_KEY
    for name in ("tree", "stages", "Pipeline", "import_chain", "consensus", "block",
                 "header", "tx", "committer", "types", "keccak", "Status"):
        setattr(ns, name, getattr(blocks, name))
    return ns


REF = _ns(BREF, name="reference", kv=jkv, wal=jwal, recovery=jrecovery, chaos=jchaos,
          nippyjar=jnippyjar, static_files=jstatic, settings=jsettings,
          historical=jhistorical, prune=jprune, native=jnative, storage=jstorage,
          tables=jtables, recover=_ref_recover, genesis=jgenesis, metrics=jmetrics)
PORT = _ns(BPORT, name="port", kv=pkv, wal=pwal, recovery=precovery, chaos=pchaos,
           nippyjar=pnippyjar, static_files=pstatic, settings=psettings,
           historical=phistorical, prune=pprune, native=pnative, storage=pstorage,
           tables=ptables, recover=_port_recover, genesis=pgenesis, metrics=pmetrics)


def init_genesis(P, factory, builder) -> None:
    """Write ``builder``'s genesis into ``factory``: the reference's own
    alloc, the port's from its plain fields and the header's RLP."""
    if P is REF:
        jgenesis.init_genesis(factory, builder.genesis, dict(builder.accounts_at_genesis),
                              storage=builder.storage_at_genesis,
                              codes=builder.codes_at_genesis, committer=ref_committer())
        return
    fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                      code=builder.codes_at_genesis.get(acc.code_hash, b""),
                      storage=builder.storage_at_genesis.get(a, {}))
              for a, acc in builder.accounts_at_genesis.items()}
    accounts, storage, codes = convert.alloc_from_fields(fields)
    pgenesis.init_genesis(factory, P.header(builder.genesis), accounts, storage=storage,
                          codes=codes, committer=np_committer())


def synced_factory(P, db, builder, n_blocks: int):
    """``db`` at ``builder``'s genesis, its blocks 1..n imported and synced
    through ``default_stages``."""
    factory = P.ProviderFactory(db)
    init_genesis(P, factory, builder)
    P.import_chain(factory, [P.block(b) for b in builder.blocks[1:n_blocks + 1]],
                   P.consensus())
    P.Pipeline(factory, P.stages()).run(n_blocks)
    return factory


def reopen(P, d: Path, name="db.bin", wal="wal"):
    """What a restart after kill -9 sees: fresh objects over disk bytes."""
    db = P.MemDb(d / name)
    return db, P.attach_wal(db, d / wal)


def tables_of(db) -> dict:
    """A MemDb's published tables, empty tables left out."""
    return {name: dict(t) for name, t in db._tables.items() if t}


def scrub(obs, base: Path):
    """``obs`` with ``base``'s absolute path made relative, ``wall_s``
    dropped and the port's ``fallbacks`` checked empty and dropped."""
    prefix = str(base) + "/"
    if isinstance(obs, dict):
        out = {}
        for k, v in obs.items():
            if k == "wall_s":
                continue
            if k == "fallbacks" and isinstance(v, dict):
                assert v == {}, v
                continue
            out[k] = scrub(v, base)
        return out
    if isinstance(obs, (list, tuple)):
        return type(obs)(scrub(v, base) for v in obs)
    if isinstance(obs, str):
        return obs.replace(prefix, "")
    if isinstance(obs, Path):
        return scrub(str(obs), base)
    return obs


def both(scenario, tmp_path: Path, *args, **kw):
    """The scenario's observation on the reference and on the port, each in
    its own directory, held equal after ``scrub``; returns the port's."""
    out = []
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        out.append(scrub(scenario(P, d, *args, **kw), d))
    assert out[1] == out[0]
    return out[1]
