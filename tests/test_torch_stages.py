"""The port's storage core and commitment stages (reth_tpu_torch/storage,
etl.py, trie/naive.py, trie/incremental.py, stages/) against the JAX
package's, on the CPU.

The same numpy-seeded inputs go through both packages, tolerance zero: the
same kv reads, encoder bytes, ETL order, hashed rows, ExecOutputs, progress
blobs, checkpoints, roots, stored branch nodes and verifier problems. The
reference runs its numpy route (``TrieCommitter(hasher=keccak256_batch_np)``
with ``turbo_backend = "numpy"``, as tests/test_merkle_resume.py does); the
port runs its ``"device"`` route on ``device="cpu"`` (the kernels' plain
versions: kernel 1 through ``KeccakDevice``, kernels 2 and 3 through
``MegaFusedEngine``) and its numpy route.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_helpers import (STAGE_BLOCK_SMALL, apply_stage_block, load_stage_state, stage_block,
                            stage_state)
from reth_tpu import etl as jetl
from reth_tpu.ops import supervisor as jsup
from reth_tpu.primitives import types as jtypes
from reth_tpu.primitives.keccak import keccak256_batch_np as jhash
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu.stages import api as japi
from reth_tpu.stages import hashing as jhashing
from reth_tpu.stages import merkle as jmerkle
from reth_tpu.storage import kv as jkv
from reth_tpu.storage import provider as jprov
from reth_tpu.storage import tables as jtables
from reth_tpu.trie import committer as jcommitter
from reth_tpu.trie import incremental as jinc
from reth_tpu.trie import naive as jnaive
from reth_tpu_torch import etl as petl
from reth_tpu_torch.ops import fused_commit as pfc
from reth_tpu_torch.ops import supervisor as psup
from reth_tpu_torch.primitives import types as ptypes
from reth_tpu_torch.primitives.keccak import keccak256_batch_np as phash
from reth_tpu_torch.stages import api as papi
from reth_tpu_torch.stages import hashing as phashing
from reth_tpu_torch.stages import merkle as pmerkle
from reth_tpu_torch.storage import kv as pkv
from reth_tpu_torch.storage import provider as pprov
from reth_tpu_torch.storage import tables as ptables
from reth_tpu_torch.trie import committer as pcommitter
from reth_tpu_torch.trie import incremental as pinc
from reth_tpu_torch.trie import naive as pnaive
from reth_tpu_torch.trie import turbo as pturbo

TABLES = ("HashedAccounts", "HashedStorages", "AccountsTrie", "StoragesTrie")
# the state of the stage tests: a few hundred accounts, slots over a tenth of them
N_ACCOUNTS, N_SLOTS, SEED = 120, 48, 5
# the state of the four-leaf chunks: one commit a chunk, so a smaller one
CHUNK4_STATE = dict(n_accounts=80, n_slots=32)


class Pkg:
    """One package's modules."""

    def __init__(self, kv, prov, tables, types, api, hashing, merkle, committer, inc, naive):
        self.kv, self.prov, self.tables, self.types = kv, prov, tables, types
        self.api, self.hashing, self.merkle = api, hashing, merkle
        self.committer, self.inc, self.naive = committer, inc, naive


JAX = Pkg(jkv, jprov, jtables, jtypes, japi, jhashing, jmerkle, jcommitter, jinc, jnaive)
PORT = Pkg(pkv, pprov, ptables, ptypes, papi, phashing, pmerkle, pcommitter, pinc, pnaive)


def ref_committer():
    c = jcommitter.TrieCommitter(hasher=jhash)
    c.turbo_backend = "numpy"
    return c


def port_committer(route: str):
    """The port's committer on the CPU: ``"device"`` (KeccakDevice and the
    turbo's device backend on their plain versions) or ``"numpy"``."""
    if route == "device":
        return pcommitter.TrieCommitter(device="cpu")
    c = pcommitter.TrieCommitter(hasher=phash, device="cpu")
    c.turbo_backend = "numpy"
    return c


def to_ref(acc):
    return jtypes.Account(acc.nonce, acc.balance, acc.storage_root, acc.code_hash)


def naive_root(accounts: dict, storages: dict) -> bytes:
    """The state root by the naive oracle of ``pkg``: each storage trie's
    root into its account, then the secure trie over the accounts."""
    leaves = {}
    for addr, acc in accounts.items():
        slots = storages.get(addr, {})
        sroot = pnaive.naive_secure_root(
            {s: rlp_encode(encode_int(v)) for s, v in slots.items() if v})
        leaves[addr] = acc.with_(storage_root=sroot).trie_encode()
    return pnaive.naive_secure_root(leaves)


class Side:
    """One package's MemDb, factory and the four commitment stages, in
    default_stages' order (MerkleUnwind, AccountHashing, StorageHashing,
    MerkleExecute)."""

    def __init__(self, pkg: Pkg, committer, chunk_leaves: int = 500_000):
        self.pkg = pkg
        self.convert = to_ref if pkg is JAX else (lambda acc: acc)
        self.db = pkg.kv.MemDb()
        self.factory = pkg.prov.ProviderFactory(self.db)
        self.committer = committer
        self.merkle = pkg.merkle.MerkleStage(committer, chunk_leaves=chunk_leaves)
        self.stages = [pkg.merkle.MerkleUnwindStage(committer),
                       pkg.hashing.AccountHashingStage(committer),
                       pkg.hashing.StorageHashingStage(committer), self.merkle]

    def header(self, number: int, root: bytes | None = None):
        kw = {} if root is None else {"state_root": root}
        return self.pkg.types.Header(number=number, **kw)

    def load(self, accounts: dict, storages: dict, root: bytes | None = None) -> None:
        load_stage_state(self.factory, {a: self.convert(acc) for a, acc in accounts.items()},
                         storages, self.header(0))
        if root is not None:
            with self.factory.provider_rw() as p:
                p.insert_header(self.header(1, root))

    def pipeline(self, stages=None):
        return self.pkg.api.Pipeline(self.factory, self.stages if stages is None else stages)

    def tables(self, names=TABLES) -> dict:
        return {name: self.db._tables.get(name, {}) for name in names}

    def execute(self, stage, target: int, checkpoint: int = 0):
        """One ``stage.execute`` in its own write transaction: its
        (checkpoint, done) and the progress blob it left."""
        with self.factory.provider_rw() as p:
            out = stage.execute(p, self.pkg.api.ExecInput(target, checkpoint))
            blob = p.stage_progress("MerkleExecute")
        return (out.checkpoint, out.done), blob


def sides(route: str, chunk_leaves: int = 500_000):
    return (Side(JAX, ref_committer(), chunk_leaves),
            Side(PORT, port_committer(route), chunk_leaves))


def same_tables(ref: Side, port: Side, names=TABLES) -> None:
    got, want = port.tables(names), ref.tables(names)
    for name in names:
        assert got[name] == want[name], name


def loaded(route: str, chunk_leaves: int = 500_000, n_accounts=N_ACCOUNTS, n_slots=N_SLOTS,
           seed=SEED, state=None):
    """Both sides loaded with the same state and header 1 at its naive root."""
    accounts, storages = state or stage_state(ptypes.Account, n_accounts, n_slots, seed)
    root = naive_root(accounts, storages)
    ref, port = sides(route, chunk_leaves)
    for s in (ref, port):
        s.load(accounts, storages, root)
    return ref, port, accounts, storages, root


# -- the storage core ----------------------------------------------------------


def _kv_reads(tx, rng_state, keys, dkeys) -> list:
    """Every read kind on one transaction, answers in a list."""
    rng = np.random.default_rng(rng_state)
    out = [tx.entry_count("T"), tx.entry_count("D")]
    for k in keys[:6]:
        out += [tx.get("T", k), tx.get("D", k), tx.get_dups("D", k)]
    for table, pool in (("T", keys), ("D", dkeys)):
        cur = tx.cursor(table)
        out += [cur.first(), cur.last(), cur.prev(), cur.next(), cur.next()]
        for _ in range(8):
            k = pool[int(rng.integers(len(pool)))]
            out += [cur.seek(k), cur.next(), cur.prev(), cur.seek_exact(k), cur.next(),
                    cur.next_no_dup(), cur.next_dup()]
        out.append(list(cur.walk()))
        out.append(list(cur.walk(pool[int(rng.integers(len(pool)))])))
        a, b = sorted(pool[int(i)] for i in rng.integers(len(pool), size=2))
        out.append(list(cur.walk_range(a, b)))
    cur = tx.cursor("D")
    for _ in range(8):
        k = dkeys[int(rng.integers(len(dkeys)))]
        sub = bytes([int(rng.integers(256))])
        out += [cur.seek_by_key_subkey(k, sub), cur.next_dup(), cur.next_dup(),
                cur.next_no_dup(), list(tx.cursor("D").walk_dup(k, sub)),
                list(tx.cursor("D").walk_dup(k))]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kv_store_reads_equal(seed):
    """One random sequence of puts, dupsort puts, deletes of keys and of
    duplicates, clears, commits and aborts through both packages' MemDb:
    every read of every cursor kind equal after each transaction, a reader
    opened before a commit still sees its snapshot, and a nested write
    transaction raises in both."""
    rng = np.random.default_rng(seed)
    keys = [bytes([a, b]) for a in range(1, 5) for b in range(0, 5)]
    dkeys = keys[:8]
    dbs = (jkv.MemDb(), pkv.MemDb())
    for step in range(24):
        ops = []
        for _ in range(int(rng.integers(1, 12))):
            kind = int(rng.integers(0, 10))
            k = keys[int(rng.integers(len(keys)))]
            v = bytes(rng.integers(0, 6, size=int(rng.integers(1, 3)), dtype=np.uint8))
            ops.append((kind, k, dkeys[int(rng.integers(len(dkeys)))], v))
        commit = bool(rng.integers(0, 4))
        state = int(rng.integers(1 << 30))
        readers = [db.tx() for db in dbs]
        before = [_kv_reads(r, state, keys, dkeys) for r in readers]
        writes = []
        for db in dbs:
            tx = db.tx_mut()
            res = []
            for kind, k, dk, v in ops:
                if kind < 3:
                    tx.put("T", k, v)
                elif kind < 6:
                    tx.put("D", dk, v, dupsort=True)
                elif kind == 6:
                    res.append(tx.delete("T", k))
                elif kind == 7:
                    res.append(tx.delete("D", dk, v))
                elif kind == 8:
                    res.append(tx.delete("D", dk))
                elif step % 7 == 3:
                    tx.clear("T")
            res.append(_kv_reads(tx, state, keys, dkeys))
            with pytest.raises(RuntimeError, match="nested write transaction"):
                db.tx_mut()
            tx.commit() if commit else tx.abort()
            writes.append(res)
        assert writes[0] == writes[1]
        # the readers opened before the write still see their snapshot
        assert [_kv_reads(r, state, keys, dkeys) for r in readers] == before
        assert before[0] == before[1]
        for r in readers:
            r.commit()
        after = [_kv_reads(db.tx(), state, keys, dkeys) for db in dbs]
        assert after[0] == after[1]


def test_kv_image_quarantine_and_flush(tmp_path):
    """flush writes a pickle image both packages read; an unreadable image
    is moved aside in both, and the store starts empty."""
    path = tmp_path / "db.bin"
    db = pkv.MemDb(path)
    with db.tx_mut() as tx:
        tx.put("T", b"k", b"v")
        tx.put("D", b"k", b"b", dupsort=True)
        tx.put("D", b"k", b"a", dupsort=True)
    db.flush()
    assert jkv.MemDb(path)._tables == pkv.MemDb(path)._tables == db._tables
    path.write_bytes(b"\x80garbage")
    q = pkv.MemDb(path)
    assert q._tables == {} and q.quarantined == tmp_path / "db.bin.corrupt-0"
    path.write_bytes(b"\x80garbage")
    assert jkv.MemDb(path).quarantined == tmp_path / "db.bin.corrupt-1"


# -- encoders --------------------------------------------------------------------


def _encodings(types, tables) -> list:
    """The table codecs' bytes for one fixed set of values of ``types``."""
    acc = types.Account(nonce=7, balance=10**20, storage_root=b"\x11" * 32,
                        code_hash=b"\x22" * 32)
    headers = [types.Header(number=9, gas_used=21_000, timestamp=1_700_000_000,
                            extra_data=b"xyz"),
               types.Header(number=10, base_fee_per_gas=7, withdrawals_root=b"\x33" * 32,
                            blob_gas_used=131072, excess_blob_gas=0,
                            parent_beacon_block_root=b"\x44" * 32, requests_hash=b"\x55" * 32)]
    auth = types.Authorization(chain_id=1, address=b"\x66" * 20, nonce=3, y_parity=1, r=5, s=6)
    txs = [types.Transaction(nonce=1, gas_price=10, to=b"\x77" * 20, value=5, data=b"\x01",
                             chain_id=1, r=1, s=2),
           types.Transaction(nonce=2, gas_price=10, to=None, value=0, data=b"\x60\x00",
                             r=3, s=4),
           types.Transaction(tx_type=1, chain_id=1, nonce=3, gas_price=9, to=b"\x88" * 20,
                             access_list=((b"\x99" * 20, (b"\x01" * 32,)),), r=5, s=6),
           types.Transaction(tx_type=2, chain_id=1, nonce=4, max_priority_fee_per_gas=2,
                             max_fee_per_gas=30, to=b"\xaa" * 20, value=1, y_parity=1, r=7, s=8),
           types.Transaction(tx_type=3, chain_id=1, nonce=5, max_fee_per_gas=30,
                             to=b"\xbb" * 20, max_fee_per_blob_gas=3,
                             blob_versioned_hashes=(b"\x01" + b"\x00" * 31,), r=9, s=10),
           types.Transaction(tx_type=4, chain_id=1, nonce=6, max_fee_per_gas=30,
                             to=b"\xcc" * 20, authorization_list=(auth,), r=11, s=12)]
    logs = (types.Log(b"\xdd" * 20, (b"\x01" * 32, b"\x02" * 32), b"data"),)
    receipts = [types.Receipt(tx_type=2, success=True, cumulative_gas_used=42_000, logs=logs),
                types.Receipt(success=False, cumulative_gas_used=1)]
    branch = types_branch(tables)
    out = [tables.encode_account(acc), tables.encode_account_changeset(b"\x01" * 20, acc),
           tables.encode_account_changeset(b"\x02" * 20, None),
           tables.encode_storage_entry(b"\x03" * 32, 2**200 + 5),
           tables.encode_branch_node(branch),
           tables.encode_storage_trie_entry(b"\x01\x02\x03", branch),
           tables.be64(123456789)]
    out += [tables.encode_header(h) for h in headers] + [h.hash for h in headers]
    out += [tables.encode_tx(t) for t in txs] + [t.hash for t in txs]
    out += [tables.encode_receipt(r) for r in receipts] + [r.encode_2718() for r in receipts]
    out += [types.logs_bloom(list(logs)), types.Block(headers[1], tuple(txs), (headers[0],),
                                                        ()).encode()]
    # the decoders give back what was encoded
    assert tables.decode_account(out[0]) == acc
    assert [tables.decode_header(tables.encode_header(h)) for h in headers] == headers
    assert [tables.decode_tx(tables.encode_tx(t)) for t in txs] == txs
    assert [tables.decode_receipt(tables.encode_receipt(r)) for r in receipts] == receipts
    assert tables.decode_storage_trie_entry(out[5])[0] == b"\x01\x02\x03"
    assert tables.decode_branch_node(out[4]).hashes == branch.hashes
    assert types.Block.decode(out[-1]).encode() == out[-1]
    return out


def types_branch(tables):
    committer = pcommitter if tables is ptables else jcommitter
    return committer.BranchNode(0b1011, 0b0010, 0b1001, (b"\x0a" * 32, b"\x0b" * 32))


def test_encoders_byte_equal():
    assert _encodings(ptypes, ptables) == _encodings(jtypes, jtables)


def test_signature_recovery_is_not_ported():
    """Signature recovery, a seam that raised NotImplementedError before the
    EVM was ported, now answers as the reference's on the same inputs."""
    def outcome(call):
        try:
            return call()
        except ValueError as e:
            return ("ValueError", str(e))

    ptx, jtx = ptypes.Transaction(nonce=1, r=1, s=2), jtypes.Transaction(nonce=1, r=1, s=2)
    assert outcome(ptx.recover_sender) == outcome(jtx.recover_sender)
    assert ptypes.recover_senders([ptx]) == jtypes.recover_senders([jtx])
    assert (outcome(ptypes.Authorization(1, b"\x01" * 20, 0).recover_authority)
            == outcome(jtypes.Authorization(1, b"\x01" * 20, 0).recover_authority))


# -- ETL ---------------------------------------------------------------------------


@pytest.mark.parametrize("buffer_bytes", [64, 512, 1 << 20])
def test_etl_collector_order_equal(buffer_bytes):
    """Random keys with many duplicates, spilled to disk at small buffers:
    both collectors give the same sorted order, duplicates in insertion
    order."""
    rng = np.random.default_rng(buffer_bytes)
    items = [(bytes(rng.integers(0, 4, size=3, dtype=np.uint8)),
              bytes(rng.integers(0, 256, size=int(rng.integers(0, 20)), dtype=np.uint8)))
             for _ in range(600)]
    got = []
    for mod in (jetl, petl):
        with mod.Collector(buffer_bytes=buffer_bytes) as col:
            for k, v in items:
                col.insert(k, v)
            got.append((list(col), len(col), len(col._files) > 1))
    assert got[0] == got[1]
    assert got[1][0] == sorted(items, key=lambda kv: kv[0])
    assert got[1][2] == (buffer_bytes < 1 << 20)


# -- hashing stages -------------------------------------------------------------


@pytest.mark.parametrize("route", ["device", "numpy"])
def test_hashing_stages_clean_incremental_unwind(route):
    """AccountHashing and StorageHashing: the clean scan, two incremental
    blocks (new, rewritten and wiped accounts, zeroed slots) and the unwind
    to 1: every hashed row equal after each step."""
    accounts, storages = stage_state(ptypes.Account, N_ACCOUNTS, N_SLOTS, SEED)
    ref, port = sides(route)
    for s in (ref, port):
        s.load(accounts, storages)
        s.hashing = s.stages[1:3]
        s.pipeline(s.hashing).run(1)
    same_tables(ref, port, TABLES[:2])
    at_1 = ref.tables(TABLES[:2])
    for b in (2, 3):
        block = stage_block(accounts, storages, b, SEED, ptypes.Account, STAGE_BLOCK_SMALL)
        for s in (ref, port):
            apply_stage_block(s.factory, block, b, convert=s.convert)
            s.pipeline(s.hashing).run(b)
        same_tables(ref, port, TABLES[:2])
    for s in (ref, port):
        s.pipeline(s.hashing).unwind(1)
    same_tables(ref, port, TABLES[:2])
    assert port.tables(TABLES[:2]) == at_1


# -- MerkleStage ------------------------------------------------------------------


@pytest.mark.parametrize("route,chunk_leaves", [("numpy", 4), ("device", 37), ("numpy", 37),
                                                ("device", 500_000), ("numpy", 500_000)])
def test_merkle_stage_step_by_step(route, chunk_leaves):
    """The hashing stages, then MerkleStage.execute one iteration at a time
    (the single-shot route at 500,000 leaves, the chunked one at 4 and 37):
    every ExecOutput, progress blob and row of the four tables equal to the
    reference stage's after each execute; then the checkpoints through the
    pipeline, and the root equal to the naive oracle's."""
    ref, port, *_ = loaded(route, chunk_leaves, **(CHUNK4_STATE if chunk_leaves == 4 else {}))
    for s in (ref, port):
        s.pipeline(s.stages[:3]).run(1)
    steps = 0
    while True:
        outs = [s.execute(s.merkle, 1) for s in (ref, port)]
        assert outs[0] == outs[1]
        same_tables(ref, port, TABLES + ("StageCheckpointProgresses",))
        steps += 1
        if outs[0][0][1]:
            break
    assert (steps > 1) == (chunk_leaves < 500_000)
    assert outs[0] == ((1, True), None)
    assert port.merkle.fallbacks == 0
    for s in (ref, port):
        s.pipeline().run(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints",))


@pytest.mark.parametrize("route", ["device", "numpy"])
def test_merkle_stage_empty_state(route):
    ref, port, _, _, root = loaded(route, n_accounts=0, n_slots=0)
    assert root == ptypes.EMPTY_ROOT_HASH
    for s in (ref, port):
        s.pipeline().run(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints",))


def _one_prefix_state(n: int = 40, seed: int = 8):
    """Accounts whose hashed addresses all share their first byte (one
    two-nibble prefix), a third of them with storage."""
    rng = np.random.default_rng(seed)
    addrs = [bytes(a) for a in rng.integers(0, 256, size=(20_000, 20), dtype=np.uint8)]
    hashed = phash(addrs)
    pick = [a for a, h in zip(addrs, hashed) if h[0] == 0x5A][:n]
    accounts = {a: ptypes.Account(nonce=i, balance=i + 1) for i, a in enumerate(pick)}
    storages = {a: {bytes([i, j]) * 16: i * 10 + j + 1 for j in range(3)}
                for i, a in enumerate(pick[: n // 3])}
    return accounts, storages


@pytest.mark.parametrize("route", ["device", "numpy"])
@pytest.mark.parametrize("chunk_leaves", [4, 500_000])
def test_merkle_stage_one_prefix_collapse(route, chunk_leaves):
    """Every account under one two-nibble prefix: the chunked route's stitch
    meets BoundaryCollapse and reveals the prefix's leaves, as the
    reference does."""
    ref, port, *_ = loaded(route, chunk_leaves, state=_one_prefix_state())
    for s in (ref, port):
        s.pipeline(s.stages[:3]).run(1)
    while True:
        outs = [s.execute(s.merkle, 1) for s in (ref, port)]
        assert outs[0] == outs[1]
        same_tables(ref, port, TABLES + ("StageCheckpointProgresses",))
        if outs[0][0][1]:
            break


@pytest.mark.parametrize("route", ["device", "numpy"])
def test_merkle_stage_stale_target_restarts(route):
    """Progress bound to an older target is discarded: the pipeline to the
    real target restarts the rebuild, in both packages alike."""
    accounts, storages = stage_state(ptypes.Account, CHUNK4_STATE["n_accounts"],
                                     CHUNK4_STATE["n_slots"], SEED)
    root = naive_root(accounts, storages)
    ref, port = sides(route, 4)
    for s in (ref, port):
        s.load(accounts, storages)
        with s.factory.provider_rw() as p:
            p.insert_header(s.header(2, root))
        s.pipeline(s.stages[:3]).run(1)
        s.blobs = [s.execute(s.merkle, 1) for _ in range(3)]
    assert ref.blobs == port.blobs and port.blobs[-1][1][1:9] == (1).to_bytes(8, "big")
    for s in (ref, port):
        s.pipeline().run(2)
    same_tables(ref, port, TABLES + ("StageCheckpoints", "StageCheckpointProgresses"))
    with port.factory.provider() as p:
        assert p.stage_progress("MerkleExecute") is None


@pytest.mark.parametrize("route", ["device", "numpy"])
def test_merkle_stage_resumes_after_pipeline_abort(route, monkeypatch):
    """RETH_TPU_FAULT_PIPELINE_ABORT kills the first pipelined chunk in both
    packages at the same iteration; the chunk rolls back to the same
    surviving progress blob, and a fresh stage resumes to equal tables."""
    ref, port, *_ = loaded(route, 4, **CHUNK4_STATE)
    for s in (ref, port):
        s.pipeline(s.stages[:3]).run(1)
        for _ in range(2):
            assert not s.execute(s.merkle, 1)[0][1]
    monkeypatch.setenv("RETH_TPU_FAULT_PIPELINE_ABORT", "1")
    aborted = {}
    for s, abort in ((ref, jsup.InjectedPipelineAbort), (port, psup.InjectedPipelineAbort)):
        for i in range(300):
            with s.factory.provider() as p:
                snap = p.stage_progress("MerkleExecute")
            try:
                s.execute(s.merkle, 1)
            except abort:
                aborted[s.pkg] = (i, snap)
                break
        with s.factory.provider() as p:
            assert p.stage_progress("MerkleExecute") == snap
    assert aborted[JAX] == aborted[PORT]
    same_tables(ref, port, TABLES + ("StageCheckpointProgresses",))
    monkeypatch.delenv("RETH_TPU_FAULT_PIPELINE_ABORT")
    for s in (ref, port):
        s.merkle = s.pkg.merkle.MerkleStage(s.committer, chunk_leaves=4)
        s.stages[3] = s.merkle
        s.pipeline().run(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints", "StageCheckpointProgresses"))


@pytest.mark.parametrize("route,chunk_leaves", [("device", 37), ("numpy", 500_000)])
def test_merkle_incremental_blocks_and_unwinds(route, chunk_leaves):
    """Blocks 2 and 3 (rewritten, new and wiped accounts, zeroed slots) on
    the incremental route, then MerkleUnwindStage's unwind to 1 and to 0:
    every table equal to the reference's after each step, block 1's tables
    back after the unwind to 1, and each root the naive oracle's."""
    ref, port, accounts, storages, _ = loaded(route, chunk_leaves)
    for s in (ref, port):
        s.pipeline().run(1)
    same_tables(ref, port)
    at_1 = port.tables()
    for b in (2, 3):
        block = stage_block(accounts, storages, b, SEED, ptypes.Account, STAGE_BLOCK_SMALL)
        root = naive_root(accounts, storages)
        for s in (ref, port):
            apply_stage_block(s.factory, block, b, s.header(b, root), convert=s.convert)
            s.pipeline().run(b)
        same_tables(ref, port, TABLES + ("StageCheckpoints",))
    for s in (ref, port):
        s.pipeline().unwind(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints", "StageCheckpointProgresses"))
    assert port.tables() == at_1
    for s in (ref, port):
        s.pipeline().unwind(0)
    same_tables(ref, port, TABLES + ("StageCheckpoints",))
    assert port.db._tables["AccountsTrie"] == {} and port.db._tables["StoragesTrie"] == {}


@pytest.mark.parametrize("chunk_leaves", [37, 500_000])
def test_merkle_stage_header_mismatch(chunk_leaves):
    """A header whose root is wrong: StageError with the reference's message
    and block."""
    accounts, storages = stage_state(ptypes.Account, N_ACCOUNTS, N_SLOTS, SEED)
    ref, port = sides("device", chunk_leaves)
    errors = []
    for s, err in ((ref, japi.StageError), (port, papi.StageError)):
        s.load(accounts, storages, b"\x01" * 32)
        with pytest.raises(err) as e:
            s.pipeline().run(1)
        errors.append((str(e.value), e.value.block))
    assert errors[0] == errors[1]
    assert "state root mismatch" in errors[1][0] and errors[1][1] == 1


def test_verify_state_root_problems_equal():
    """verify_state_root on a corrupted branch node and a stale cached
    storage root: the same recomputed root and problem list."""
    ref, port, _, _, root = loaded("device")
    out = []
    for s in (ref, port):
        s.pipeline().run(1)
        with s.factory.provider_rw() as p:
            path, raw = next(iter(p.tx.cursor("AccountsTrie").walk()))
            node = s.pkg.tables.decode_branch_node(raw)
            p.put_account_branch(path, type(node)(node.state_mask, node.tree_mask,
                                                  node.hash_mask,
                                                  (b"\xee" * 32,) + node.hashes[1:]))
            k, v = next(iter(p.tx.cursor("HashedAccounts").walk()))
            acc = s.pkg.tables.decode_account(v)
            p.tx.put("HashedAccounts", k,
                     s.pkg.tables.encode_account(acc.with_(storage_root=b"\xdd" * 32)))
        with s.factory.provider() as p:
            out.append(s.pkg.inc.verify_state_root(p, s.committer))
    assert out[0] == out[1]
    assert out[1][0] == root and len(out[1][1]) == 2


def test_naive_secure_root_agrees():
    accounts, storages = stage_state(ptypes.Account, N_ACCOUNTS, N_SLOTS, SEED)
    pairs = {a: acc.trie_encode() for a, acc in accounts.items()}
    assert pnaive.naive_secure_root(pairs) == jnaive.naive_secure_root(pairs)
    assert pnaive.naive_trie_root({}) == jnaive.naive_trie_root({}) == ptypes.EMPTY_ROOT_HASH
    ref, port, _, _, root = loaded("device")
    for s in (ref, port):
        s.pipeline().run(1)
    assert root == ref.header(1, root).state_root
    with port.factory.provider() as p:
        assert p.header_by_number(1).state_root == root


def test_reference_device_route_agrees():
    """One small case through the reference's turbo_backend="device" (its
    JAX engines on the CPU) against the port's device route."""
    accounts, storages = stage_state(ptypes.Account, 120, 40, SEED)
    root = naive_root(accounts, storages)
    jc = jcommitter.TrieCommitter(hasher=jhash)
    jc.turbo_backend = "device"
    ref, port = Side(JAX, jc, 37), Side(PORT, port_committer("device"), 37)
    for s in (ref, port):
        s.load(accounts, storages, root)
        s.pipeline().run(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints",))


# -- no fallback on a device fault ------------------------------------------------


@pytest.mark.parametrize("chunk_leaves", [37, 500_000])
def test_device_fault_raises_out_of_execute(chunk_leaves, monkeypatch):
    """A kernel wrapper that raises RuntimeError: the port's MerkleStage
    raises out of execute (no fall to the general committer), and the
    stage's progress stays as it was."""
    _, port, *_ = loaded("device", chunk_leaves)
    port.pipeline(port.stages[:3]).run(1)

    def launch_fault(*args):
        raise RuntimeError("packed_level: an illegal memory access was encountered")

    monkeypatch.setattr(pfc, "packed_level", launch_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        for _ in range(50):
            port.execute(port.merkle, 1)
    assert port.merkle.fallbacks == 0


@pytest.mark.parametrize("chunk_leaves", [37, 500_000])
def test_sweep_value_error_falls_back(chunk_leaves, monkeypatch):
    """The sweep rejecting its input (ValueError) still takes the general
    committer: the reference's root and tables, one fallback counted per
    rejected commit."""
    ref, port, *_ = loaded("device", chunk_leaves)

    def rejected(*args, **kwargs):
        raise ValueError("triebuild failed (err=4: oversized leaf value)")

    monkeypatch.setattr(pturbo, "_marshal_and_build", rejected)
    commits = []
    turbo_commit = port.merkle._commit_subtries
    port.merkle._commit_subtries = lambda *a, **k: commits.append(1) or turbo_commit(*a, **k)
    for s in (ref, port):
        s.pipeline().run(1)
    same_tables(ref, port, TABLES + ("StageCheckpoints",))
    # single-shot: one rejected rebuild; chunked: one a turbo chunk
    assert port.merkle.fallbacks == (1 if chunk_leaves == 500_000 else len(commits))
    assert chunk_leaves == 500_000 or len(commits) > 1


def test_static_files_and_default_stages_not_ported():
    # static files are ported: the factory hands its provider to every
    # provider it makes (tests/test_torch_storage_v2.py holds the reads)
    static = object()
    factory = pprov.ProviderFactory(pkv.MemDb(), static_files=static)
    assert factory.static_files is static
    assert factory.provider().static_files is static
    assert factory.provider_rw().static_files is static
    from reth_tpu import stages as jstages
    from reth_tpu_torch import stages

    # default_stages is ported: the reference's stage set in its order
    assert ([st.id for st in stages.default_stages(device="cpu")]
            == [st.id for st in jstages.default_stages()])


def test_reveal_converges_past_the_reference_bound():
    """A departure kept on purpose: an incremental root whose account trie
    collapses at more boundaries than the reference's 64 reveal retries
    (here a hundred deleted leaves, each the sibling of one other leaf under
    its branch). The reference gives up ("boundary reveal did not
    converge"); the port reveals every collapse of a retry at once and
    lands on the full rebuild's root and branch nodes."""
    rng = np.random.default_rng(21)
    keys = np.unique(rng.integers(0, 256, size=(3000, 32), dtype=np.uint8).view("S32").ravel())
    rows = {bytes(k): ptables.encode_account(ptypes.Account(nonce=i, balance=i + 1))
            for i, k in enumerate(keys.tolist())}
    ref, port = sides("numpy")
    for s in (ref, port):
        with s.factory.provider_rw() as p:
            for k, v in rows.items():
                p.tx.put("HashedAccounts", k, v)
            s.pkg.inc.full_state_root(p, s.committer)
    doomed = []
    with port.factory.provider() as p:
        for path, raw in p.tx.cursor("AccountsTrie").walk():
            node = ptables.decode_branch_node(raw)
            if bin(node.state_mask).count("1") == 2 and node.hash_mask == node.state_mask \
                    and node.tree_mask == 0 and len(doomed) < 100:
                nib = (node.state_mask & -node.state_mask).bit_length() - 1
                start, end = pinc.nibbles_range(path + bytes([nib]))
                doomed += [k for k, _ in p.tx.cursor("HashedAccounts").walk_range(start, end)]
    assert len(doomed) == 100
    outs = []
    for s in (ref, port):
        with s.factory.provider_rw() as p:
            for k in doomed:
                p.tx.delete("HashedAccounts", k)
            inc = s.pkg.inc.IncrementalStateRoot(p, s.committer)
            if s is ref:
                with pytest.raises(RuntimeError, match="did not converge"):
                    inc.compute(set(doomed))
                continue
            outs.append(inc.compute(set(doomed)))
    with port.factory.provider() as p:
        root, problems = pinc.verify_state_root(p, port.committer)
    assert problems == [] and outs == [root]
    assert root == pnaive.naive_trie_root({k: v for k, v in rows.items() if k not in doomed})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_ranges_equal(seed):
    """The port's prefix-lookup _dedup_ranges gives the reference's ranges."""
    rng = np.random.default_rng(seed)
    ranges = [bytes(rng.integers(0, 4, size=int(rng.integers(0, 6)), dtype=np.uint8))
              for _ in range(400)]
    assert pinc._dedup_ranges(ranges) == jinc._dedup_ranges(ranges)
    assert pinc._dedup_ranges([]) == jinc._dedup_ranges([]) == []
