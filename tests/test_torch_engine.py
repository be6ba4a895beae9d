"""The engine tree of the port (engine/tree.py and what it drives: the
overlay, the block buffer, the sparse and pipelined root strategies, the
hot-state plane, reorgs, deep-reorg unwinds, persistence) against the JAX
package's, on the CPU, tolerance zero.

Each chain is built by the JAX package's ``ChainBuilder`` on its numpy
committer (the small staged-sync chain, tests/_torch_helpers.py
``SyncChain`` at ``SYNC_BLOCK_SMALL``, or tests/test_engine_tree.py's
transfer chains) and carried across by its RLP and its genesis by plain
fields. Both trees get the same messages; statuses, roots, ``last_sparse``
strategies and, after persistence, every table row must be equal. The port's
tree runs on ``device="cpu"``: a numpy-hashing committer for speed, or its
card route's plain versions (kernel 1's for the hasher, kernel 4's for the
hot-state arena) where a test says so. The reference's sparse write-back can
leave a stored branch's ``tree_mask`` bit clear (ROADMAP C), so the
trie tables of a sparse run are held against the reference's incremental
route.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from _torch_helpers import SYNC_BLOCK_SMALL, SyncChain
from reth_tpu import testing as jtesting
from reth_tpu.engine import EngineTree as JEngineTree
from reth_tpu.primitives import keccak as jkeccak
from reth_tpu.primitives import secp256k1 as jsecp
from reth_tpu.primitives import types as jtypes
from reth_tpu.storage import MemDb as JMemDb
from reth_tpu.storage import ProviderFactory as JFactory
from reth_tpu.storage import genesis as jgenesis
from reth_tpu.storage.overlay import OverlayTx as JOverlayTx
from reth_tpu.storage.overlay import apply_layer as japply_layer
from reth_tpu.trie.committer import TrieCommitter as JCommitter
from reth_tpu_torch import convert
from reth_tpu_torch.consensus import EthBeaconConsensus
from reth_tpu_torch.engine import EngineTree, SparseRootError
from reth_tpu_torch.engine.util import EngineFaultInjector, EngineMessageStore
from reth_tpu_torch.ops import fused_commit as fc
from reth_tpu_torch.ops._build import BuildError, LaunchError, is_kernel_fault
from reth_tpu_torch.primitives import keccak as pkeccak
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.storage import MemDb, ProviderFactory
from reth_tpu_torch.storage import genesis as pgenesis
from reth_tpu_torch.storage.overlay import OverlayTx, apply_layer
from reth_tpu_torch.storage.recovery import UNWIND_MARKER_KEY
from reth_tpu_torch.trie.committer import TrieCommitter

JAX = types.SimpleNamespace(testing=jtesting, types=jtypes, keccak=jkeccak, secp256k1=jsecp)
TRIE_TABLES = ("AccountsTrie", "StoragesTrie")


def ref_committer():
    return JCommitter(hasher=jkeccak.keccak256_batch_np)


def np_committer():
    return TrieCommitter(hasher=pkeccak.keccak256_batch_np, device="cpu")


def port_block(blk):
    return ptypes.Block.decode(blk.encode())


def status(st):
    return (st.status.value, st.latest_valid_hash, st.validation_error)


def tables(db) -> dict:
    return {name: dict(rows) for name, rows in db._tables.items() if rows}


class Pair:
    """A reference tree and a port tree over one reference builder's genesis,
    fed the same messages. ``card_route``: the port's committer is
    ``TrieCommitter(device="cpu")`` (the card route's plain versions)
    instead of a numpy-hashing one. ``kw`` goes to both ``EngineTree``s."""

    def __init__(self, builder, card_route: bool = False, **kw):
        self.builder = builder
        self.ref = JFactory(JMemDb())
        jgenesis.init_genesis(self.ref, builder.genesis, dict(builder.accounts_at_genesis),
                              storage=builder.storage_at_genesis,
                              codes=builder.codes_at_genesis, committer=ref_committer())
        fields = {a: dict(nonce=acc.nonce, balance=acc.balance,
                          code=builder.codes_at_genesis.get(acc.code_hash, b""),
                          storage=builder.storage_at_genesis.get(a, {}))
                  for a, acc in builder.accounts_at_genesis.items()}
        accounts, storage, codes = convert.alloc_from_fields(fields)
        self.port = ProviderFactory(MemDb())
        pgenesis.init_genesis(self.port, ptypes.Header.decode(builder.genesis.encode()),
                              accounts, storage=storage, codes=codes, committer=np_committer())
        self.rtree = JEngineTree(self.ref, committer=ref_committer(), **kw)
        committer = TrieCommitter(device="cpu") if card_route else np_committer()
        self.ptree = EngineTree(self.port, committer=committer,
                                consensus=EthBeaconConsensus(np_committer(), device="cpu"),
                                device="cpu", **kw)

    def payload(self, blk):
        want = status(self.rtree.on_new_payload(blk))
        got = status(self.ptree.on_new_payload(port_block(blk)))
        assert got == want
        strategy = lambda t: (t.last_sparse or {}).get("strategy")
        assert strategy(self.ptree) == strategy(self.rtree)
        return got

    def fcu(self, head: bytes):
        want = status(self.rtree.on_forkchoice_updated(head))
        got = status(self.ptree.on_forkchoice_updated(head))
        assert got == want
        assert (self.ptree.head_hash, self.ptree.persisted_number) == \
            (self.rtree.head_hash, self.rtree.persisted_number)
        return got

    def persist_all(self):
        """One more fcU to the head with a threshold of 0."""
        for t in (self.rtree, self.ptree):
            t.persistence_threshold = 0
        self.fcu(self.ptree.head_hash)

    def same_tables(self, trie_from=None):
        """Every table row equal; with ``trie_from`` (a reference factory),
        the trie tables equal that database's instead."""
        got, want = tables(self.port.db), tables(self.ref.db)
        if trie_from is not None:
            inc = tables(trie_from.db)
            for name in TRIE_TABLES:
                want[name] = inc.get(name)
            want = {k: v for k, v in want.items() if v}
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name


@pytest.fixture(scope="module")
def chain():
    return SyncChain(JAX, n_accounts=60, n_slots=24, seed=47, n_wallets=4, n_blocks=3,
                     sizes=SYNC_BLOCK_SMALL, committer=ref_committer()).builder


@pytest.fixture(scope="module")
def incremental(chain):
    """The reference's incremental route over the chain, persisted to the
    tip: the trie tables a sparse write-back must equal."""
    f = JFactory(JMemDb())
    jgenesis.init_genesis(f, chain.genesis, dict(chain.accounts_at_genesis),
                          storage=chain.storage_at_genesis, codes=chain.codes_at_genesis,
                          committer=ref_committer())
    tree = JEngineTree(f, committer=ref_committer(), state_root_strategy="pipelined",
                       persistence_threshold=0)
    for blk in chain.blocks[1:]:
        assert tree.on_new_payload(blk).status.value == "VALID"
        tree.on_forkchoice_updated(blk.hash)
    return f


STRATEGIES = {
    "sparse": dict(state_root_strategy="sparse", hot_state=False),
    "sparse hot": dict(state_root_strategy="sparse", hot_state=True),
    "sparse card route": dict(state_root_strategy="sparse", hot_state=True, card_route=True),
    "pipelined": dict(state_root_strategy="pipelined", hot_state=False),
    "pipelined card route": dict(state_root_strategy="pipelined", hot_state=False,
                                 card_route=True),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_chain_matches_reference(chain, incremental, name):
    """newPayload + fcU for each block, then persistence to the tip: equal
    statuses and strategies, every root the header's, equal tables."""
    pair = Pair(chain, sparse_workers=1, persistence_threshold=2, **STRATEGIES[name])
    for blk in chain.blocks[1:]:
        assert pair.payload(blk) == ("VALID", blk.hash, None)
        pair.fcu(blk.hash)
    if STRATEGIES[name]["state_root_strategy"] == "sparse":
        assert pair.ptree.last_sparse["strategy"] == "sparse"
        assert pair.ptree.sparse_fallbacks == 0
        # the prewarm workers fed the sparse task's proof prefetch
        assert pair.ptree.last_prewarm.streamed_keys == \
            pair.rtree.last_prewarm.streamed_keys > 0
    else:
        assert pair.ptree.last_sparse is None
    assert pair.ptree.persisted_number == len(chain.blocks) - 3
    pair.persist_all()
    assert pair.ptree.persisted_number == len(chain.blocks) - 1
    with pair.port.provider() as p:
        assert p.stage_checkpoint("Finish") == len(chain.blocks) - 1
        assert p.header_by_number(len(chain.blocks) - 1).hash == chain.blocks[-1].hash
    sparse = STRATEGIES[name]["state_root_strategy"] == "sparse"
    pair.same_tables(trie_from=incremental if sparse else None)
    if STRATEGIES[name]["hot_state"]:
        arena = pair.ptree.hot_arena
        assert arena.faults == 0 and arena.leaked_rows() == 0
        assert pair.ptree.hot_cache is not None


def test_block_timeline_records_the_tree_phases(chain):
    """With tracing on, a block's newPayload leaves its timeline (trace id:
    the block hash) with the tree's phase spans, the sparse task's spans
    from its worker thread, and a wall-budget summary, as the reference's
    does."""
    from reth_tpu import tracing as jtracing
    from reth_tpu_torch import tracing

    pair = Pair(chain, sparse_workers=1)
    blk = chain.blocks[1]
    jtracing.set_trace_enabled(True)
    tracing.set_trace_enabled(True)
    try:
        pair.payload(blk)
    finally:
        jtracing.set_trace_enabled(False)
        tracing.set_trace_enabled(False)

    def names(mod):
        return {r["name"] for r in mod.block_timeline(blk.hash.hex()) if r["kind"] == "span"}

    got = names(tracing)
    assert {"block", "validate", "execute", "post_validate", "write_overlay", "state_root",
            "finalize", "key_hash", "sparse.finish"} <= got
    assert got == names(jtracing)
    summary = tracing.block_summary(blk.hash.hex())
    assert summary["number"] == 1 and summary["root_ms"] > 0 and summary["exec_ms"] > 0
    assert set(summary) == set(jtracing.block_summary(blk.hash.hex()))


def test_unknown_parent_is_syncing_then_replayed(chain):
    pair = Pair(chain, sparse_workers=1)
    b1, b2, b3 = chain.blocks[1:4]
    assert pair.payload(b2)[0] == "SYNCING"
    assert pair.payload(b3)[0] == "SYNCING"
    assert len(pair.ptree.buffered) == len(pair.rtree.buffered) == 2
    # the parent arrives: its buffered descendants replay behind it
    assert pair.payload(b1)[0] == "VALID"
    assert set(pair.ptree.blocks) == set(pair.rtree.blocks) == {b1.hash, b2.hash, b3.hash}
    assert len(pair.ptree.buffered) == 0


def _with_header(pkg, blk, **fields):
    header = pkg.types.Header(**{**blk.header.__dict__, **fields})
    return pkg.types.Block(header, blk.transactions, (), blk.withdrawals)


def test_invalid_root_rejected_with_descendants(chain):
    pair = Pair(chain, sparse_workers=1)
    bad = _with_header(JAX, chain.blocks[1], state_root=b"\x13" * 32)
    st = pair.payload(bad)
    assert st[0] == "INVALID" and "state root mismatch" in st[2]
    child = _with_header(JAX, chain.blocks[2], parent_hash=bad.hash)
    assert pair.payload(child) == ("INVALID", None, "invalid ancestor")
    assert pair.fcu(bad.hash)[0] == "INVALID"
    # the good block still validates, and the bad one did not poison the
    # preserved trie
    assert pair.payload(chain.blocks[1])[0] == "VALID"
    assert pair.payload(chain.blocks[2])[0] == "VALID"


def _transfer_builders(n_a: int, n_b: int, branch: int):
    """tests/test_engine_tree.py's forks: fork A transfers 100 + i to 0xaa..,
    fork B follows it for ``branch`` blocks, then transfers 999 to 0xbb.."""
    out = []
    for n, tail in ((n_a, False), (n_b, True)):
        alice = jtesting.Wallet(0xA11CE)
        b = jtesting.ChainBuilder({alice.address: jtypes.Account(balance=10**21)},
                                  committer=ref_committer())
        for i in range(n):
            if tail and i >= branch:
                b.build_block([alice.transfer(b"\xbb" * 20, 999 + i)], timestamp=100 + i)
            else:
                b.build_block([alice.transfer(b"\xaa" * 20, 100 + i)])
        out.append(b)
    return out


@pytest.mark.parametrize("strategy", ["sparse", "pipelined"])
def test_reorg_between_forks(strategy):
    a, b = _transfer_builders(2, 2, 0)
    pair = Pair(a, sparse_workers=1, persistence_threshold=10, state_root_strategy=strategy)
    for blk in (a.blocks[1], b.blocks[1], a.blocks[2], b.blocks[2]):
        assert pair.payload(blk)[0] == "VALID"
    for head in (a.blocks[2].hash, b.blocks[2].hash, a.blocks[1].hash, b.blocks[2].hash):
        pair.fcu(head)
        for who in (b"\xaa" * 20, b"\xbb" * 20):
            got = pair.ptree.overlay_provider().account(who)
            want = pair.rtree.overlay_provider().account(who)
            assert (got and got.balance) == (want and want.balance)


def test_deep_reorg_unwinds_the_persisted_chain():
    """A fork branching below the persisted tip: the fcU unwinds the
    persisted chain through the port's stages (the unwind marker written and
    cleared), replays the fork and persists it; tables equal after."""
    a, b = _transfer_builders(4, 3, 2)
    pair = Pair(a, sparse_workers=1, persistence_threshold=1)
    for blk in a.blocks[1:]:
        assert pair.payload(blk)[0] == "VALID"
        pair.fcu(blk.hash)
    assert pair.ptree.persisted_number == 3
    fork3 = b.blocks[3]
    assert fork3.header.parent_hash == a.blocks[2].hash
    assert pair.payload(fork3)[0] == "SYNCING"
    assert pair.fcu(fork3.hash)[0] == "VALID"
    with pair.port.provider() as p:
        assert p.tx.get("Metadata", UNWIND_MARKER_KEY) is None
        assert p.last_block_number() == 2
    got = pair.ptree.overlay_provider()
    assert got.account(b"\xbb" * 20).balance == 1001
    assert got.account(b"\xaa" * 20).balance == 100 + 101
    assert pair.ptree.reorgs.reorgs == pair.rtree.reorgs.reorgs
    pair.persist_all()
    pair.same_tables()


def test_canon_notifications_and_fcu_listeners(chain):
    pair = Pair(chain, sparse_workers=1)
    seen = {"ref": [], "port": []}
    heads = {"ref": [], "port": []}
    pair.rtree.canon_listeners.append(lambda c: seen["ref"].append([b.number for b in c]))
    pair.ptree.canon_listeners.append(lambda c: seen["port"].append([b.number for b in c]))
    pair.rtree.fcu_listeners.append(lambda n, h: heads["ref"].append((n, h)))
    pair.ptree.fcu_listeners.append(lambda n, h: heads["port"].append((n, h)))
    for blk in chain.blocks[1:4]:
        pair.payload(blk)
        pair.fcu(blk.hash)
    assert seen["port"] == seen["ref"] == [[1], [1, 2], [2, 3]]
    assert heads["port"] == heads["ref"]


def test_injected_sparse_abort_falls_back(chain, incremental, monkeypatch):
    """RETH_TPU_FAULT_SPARSE_ABORT: each block's sparse commit aborts at its
    first dispatch, the tree reruns it on the incremental committer, as the
    reference's does; the port counts each fallback."""
    monkeypatch.setenv("RETH_TPU_FAULT_SPARSE_ABORT", "1")
    pair = Pair(chain, sparse_workers=1, persistence_threshold=0)
    for k, blk in enumerate(chain.blocks[1:], 1):
        assert pair.payload(blk) == ("VALID", blk.hash, None)
        assert pair.ptree.last_sparse["strategy"] == "fallback"
        assert "injected sparse-commit abort" in pair.ptree.last_sparse["error"]
        assert pair.ptree.sparse_fallbacks == k
        pair.fcu(blk.hash)
    pair.same_tables(trie_from=incremental)


def test_engine_middleware_on_the_port(chain, tmp_path):
    """engine/util.py: skipped messages answer SYNCING, an injected reorg
    walks the tree back and forth, a recorded stream replays."""
    pair = Pair(chain, sparse_workers=1)
    inj = EngineFaultInjector(pair.ptree, skip_new_payload=3, reorg_frequency=2)
    store = EngineMessageStore(inj, tmp_path / "msgs.jsonl")
    statuses = []
    for blk in chain.blocks[1:]:
        pb = port_block(blk)
        statuses.append(store.on_new_payload(pb).status.value)
        if statuses[-1] == "SYNCING":
            statuses.append(store.on_new_payload(pb).status.value)
        store.on_forkchoice_updated(pb.hash)
    assert statuses.count("SYNCING") == 1 and inj.skipped_payloads == 1
    assert inj.injected_reorgs >= 1
    assert pair.ptree.head_hash == chain.blocks[-1].hash
    fresh = Pair(chain, sparse_workers=1)
    n = EngineMessageStore.replay(tmp_path / "msgs.jsonl", fresh.ptree)
    assert n == 2 * len(chain.blocks[1:]) + 1
    assert fresh.ptree.head_hash == chain.blocks[-1].hash


# -- the overlay over the port's Tx ----------------------------------------------


def _overlay_ops(seed: int):
    """A base table map and two layers of writes over it: puts, deletes of
    whole keys, and removed duplicates (a storage slot written to zero)."""
    rng = np.random.default_rng(seed)
    keys = [bytes([k]) * 4 for k in range(1, 13)]
    subs = [bytes([s]) + b"\x00" * 3 for s in range(1, 9)]
    base = [("d", k, s + bytes([v])) for k in keys[:8] for s, v in
            zip(subs, rng.integers(0, 255, size=len(subs))) if rng.random() < 0.6]
    base += [("t", k, bytes([i])) for i, k in enumerate(keys[:8])]
    layers = []
    for _ in range(2):
        ops = []
        for _ in range(24):
            k = keys[int(rng.integers(0, len(keys)))]
            roll = rng.random()
            if roll < 0.35:
                s = subs[int(rng.integers(0, len(subs)))]
                ops.append(("put_dup", "d", k, s + bytes([int(rng.integers(0, 255))])))
            elif roll < 0.55:
                ops.append(("zero", "d", k, subs[int(rng.integers(0, len(subs)))]))
            elif roll < 0.65:
                ops.append(("delete", "d", k, None))
            elif roll < 0.85:
                ops.append(("put", "t", k, bytes([int(rng.integers(0, 255))])))
            else:
                ops.append(("delete", "t", k, None))
        layers.append(ops)
    return base, layers, keys, subs


def _build_overlay(db_cls, ov_cls, base, layers):
    db = db_cls()
    with db.tx_mut() as tx:
        for table, k, v in base:
            tx.put(table, k, v, dupsort=(table == "d"))
    built = []
    for ops in layers:
        ov = ov_cls(db.tx(), built)
        for op, table, k, v in ops:
            if op == "put_dup":
                # a slot write: the old value of the subkey goes first
                old = ov.cursor(table).seek_by_key_subkey(k, v[:4])
                if old is not None and old[1][:4] == v[:4]:
                    ov.delete(table, k, old[1])
                ov.put(table, k, v, dupsort=True)
            elif op == "zero":
                old = ov.cursor(table).seek_by_key_subkey(k, v)
                if old is not None and old[1][:4] == v:
                    ov.delete(table, k, old[1])
            elif op == "put":
                ov.put(table, k, v)
            else:
                ov.delete(table, k)
        built.append(ov.layer)
    return db, built


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_overlay_seek_dup_and_cursors_match_reference(seed):
    """``OverlayTx.seek_dup`` lands where a cursor over the merged layers
    does (a deleted key and a removed duplicate hide the base's), the
    cursors walk the reference overlay's rows, and applying the layers
    leaves the reference's tables."""
    base, layers, keys, subs = _overlay_ops(seed)
    pdb, players = _build_overlay(MemDb, OverlayTx, base, layers)
    jdb, jlayers = _build_overlay(JMemDb, JOverlayTx, base, layers)
    pov = OverlayTx(pdb.tx(), players)
    jov = JOverlayTx(jdb.tx(), jlayers)
    for table in ("d", "t"):
        assert list(pov.cursor(table).walk()) == list(jov.cursor(table).walk())
        assert pov.entry_count(table) == jov.entry_count(table)
    hidden = 0
    for k in keys:
        for sub in [b""] + subs + [b"\xff"]:
            want = jov.cursor("d").seek_by_key_subkey(k, sub)
            got = pov.seek_dup("d", k, sub)
            assert got == (want[1] if want is not None else None)
            assert pov.cursor("d").seek_by_key_subkey(k, sub) == want
            base_dup = pdb.tx().seek_dup("d", k, sub)
            hidden += base_dup is not None and base_dup != got
        assert pov.get_dups("d", k) == jov.get_dups("d", k)
        assert pov.get("t", k) == jov.get("t", k)
    assert hidden > 0  # the layers do hide base rows
    with pdb.tx_mut() as tx:
        for layer in players:
            apply_layer(tx, layer)
    with jdb.tx_mut() as tx:
        for layer in jlayers:
            japply_layer(tx, layer)
    assert tables(pdb) == tables(jdb)


# -- departures: a kernel fault raises out of on_new_payload -------------------------


def _failing_hasher(after: int = 0):
    calls = {"n": 0}
    inner = pkeccak.keccak256_batch_np

    def hasher(msgs):
        calls["n"] += 1
        if calls["n"] > after:
            raise LaunchError("keccak256_absorb: CUDA error 700 at launch")
        return inner(msgs)
    return hasher, calls


@pytest.mark.parametrize("strategy", ["sparse", "pipelined"])
def test_hasher_launch_fault_raises_out_of_new_payload(chain, strategy):
    """A launch fault in the committer's hasher is no fallback cause: the
    sparse task's failure reaches on_new_payload with the fault as its cause,
    and the pipelined route counts the failed prehash batch, then raises when
    finish hashes the keys again. The reference's tree swallows neither."""
    pair = Pair(chain, sparse_workers=1, state_root_strategy=strategy)
    hasher, calls = _failing_hasher()
    pair.ptree.committer = TrieCommitter(hasher=hasher, device="cpu")
    blk = port_block(chain.blocks[1])
    with pytest.raises((SparseRootError, LaunchError)) as info:
        pair.ptree.on_new_payload(blk)
    err = info.value
    while not isinstance(err, LaunchError):
        err = err.__cause__
    assert "CUDA error 700" in str(err)
    assert calls["n"] >= 1
    assert pair.ptree.sparse_fallbacks == 0
    assert blk.hash not in pair.ptree.blocks


def test_arena_launch_fault_raises_out_of_new_payload(chain, monkeypatch):
    """The tree's hot-state arena raises a launch fault of its delta finish
    (kernel 4) instead of rerunning the commit on the classic finish
    (kernel 1), and the tree does not fall back: on_new_payload raises. A
    failure of the same finish that is no kernel fault still reruns
    classic, as in the reference."""
    pair = Pair(chain, sparse_workers=1, hot_state=True, card_route=True)
    assert pair.payload(chain.blocks[1])[0] == "VALID"
    pair.fcu(chain.blocks[1].hash)

    def failing(*_a):
        raise LaunchError("subtrie_levels: CUDA error 719 at launch")

    monkeypatch.setattr(fc, "subtrie_levels", failing)
    blk = port_block(chain.blocks[2])
    with pytest.raises(SparseRootError) as info:
        pair.ptree.on_new_payload(blk)
    assert isinstance(info.value.__cause__, LaunchError)
    assert pair.ptree.hot_arena.faults == 1
    assert pair.ptree.sparse_fallbacks == 0
    assert blk.hash not in pair.ptree.blocks
    # a failure that is no kernel fault: evict, rerun classic, VALID

    def broken(*_a):
        raise ValueError("injected template fault")

    monkeypatch.setattr(fc, "subtrie_levels", broken)
    assert pair.ptree.on_new_payload(blk).status.value == "VALID"
    assert pair.ptree.hot_arena.faults >= 2
    assert pair.ptree.last_sparse["strategy"] == "sparse"


@pytest.mark.parametrize("err", [LaunchError("subtrie_levels: CUDA error 719 at launch"),
                                 BuildError("building fused_level.cu failed")],
                         ids=["launch", "build"])
def test_arena_raises_kernel_faults_for_every_owner(err, monkeypatch):
    """An arena outside the tree (the sparse task's and the hot tip's own)
    raises a kernel fault of its epoch out of the commit after evicting and
    counting it; the next commit takes a full epoch with the same root as
    the classic finish."""
    from reth_tpu_torch.trie import sparse as ts

    def tries():
        t = ts.SparseTrie()
        for i in range(24):
            t.update(pkeccak.keccak256(bytes([i])), bytes([i + 1]) * 30)
        return t

    arena = fc.DigestArena()
    c = ts.ParallelSparseCommitter(workers=1, arena=arena, device="cpu")

    def failing(*_a):
        raise err

    monkeypatch.setattr(fc, "subtrie_levels", failing)
    with pytest.raises(type(err)):
        c.commit([tries()], pkeccak.keccak256_batch_np)
    assert (arena.faults, arena.evictions, arena.engine, arena.leaked_rows()) == (1, 1, None, 0)
    monkeypatch.undo()
    (root,) = c.commit([tries()], pkeccak.keccak256_batch_np)
    assert c.last["arena_fresh"] is True
    classic = ts.ParallelSparseCommitter(workers=1, device="cpu")
    assert root == classic.commit([tries()], pkeccak.keccak256_batch_np)[0]


def _raised(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — the error itself is the subject
        return e
    raise AssertionError("no error")


def test_is_kernel_fault_reads_torch_device_errors():
    """PyTorch's own errors of a device count as kernel faults, along the
    cause chain and in any case of the word: the error a CUDA tensor raises
    on a build without a card, the types of PyTorch's device errors, and a
    device mismatch; an injected fault that names no device does not."""
    import torch

    no_card = _raised(lambda: torch.zeros(1, device="cuda"))
    assert is_kernel_fault(no_card)
    for kind in ("AcceleratorError", "OutOfMemoryError"):
        if hasattr(torch, kind):
            assert is_kernel_fault(getattr(torch, kind)("an illegal memory access"))
    mismatch = RuntimeError("Expected all tensors to be on the same device, but found "
                            "at least two devices, cuda:0 and cpu!")
    assert is_kernel_fault(mismatch)
    wrapped = SparseRootError("parallel commit failed")
    wrapped.__cause__ = no_card
    assert is_kernel_fault(wrapped)
    assert not is_kernel_fault(RuntimeError("injected launch fault"))
    assert not is_kernel_fault(SparseRootError("blinded node did not converge"))
