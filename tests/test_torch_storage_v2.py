"""The port's split store, history reads, pruner and static files
(``reth_tpu_torch/storage/{settings,historical,static_files,nippyjar}.py``,
``storage/__init__.py open_database``, ``prune.py``) against the JAX
package's.

The non-``Node``, non-RPC cases of ``tests/test_storage_v2.py`` and
``test_history.py`` (its engine-persistence case reads history the way
``rpc/eth.py``'s ``_state_at`` does, through ``HistoricalStateProvider`` over
the tree's overlay, without the RPC layer), and the pruner and static-file
cases of ``test_aux.py`` and ``test_aux2.py``, each one scenario run on both
packages (``_torch_storage_pkgs.both``) on the reference's chains carried
across by RLP, their observations held equal. Jars and WAL segments written
by each package are read by the other.
"""

from __future__ import annotations

import json
import random
import struct
import zlib

import pytest

from _torch_storage_pkgs import (
    PORT,
    REF,
    Account,
    ChainBuilder,
    Wallet,
    both,
    init_genesis,
    reopen,
    synced_factory,
    tables_of,
)
from reth_tpu.primitives.keccak import keccak256, keccak256_batch_np
from reth_tpu.primitives.rlp import encode_int, rlp_encode
from reth_tpu.trie import TrieCommitter as JCommitter

STORE = bytes.fromhex("5f355f5500")  # sstore(0, calldata[0])


def _committer():
    return JCommitter(hasher=keccak256_batch_np)


@pytest.fixture(scope="module")
def v2_chain():
    """``test_storage_v2.py``'s chain: a transfer and a storage write a block."""
    caddr = b"\x5a" * 20
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21),
                            caddr: Account(code_hash=keccak256(STORE))},
                           codes={keccak256(STORE): STORE}, committer=_committer())
    for i in range(4):
        builder.build_block([alice.transfer(b"\x0b" * 20, 100 + i),
                             alice.call(caddr, (i + 1).to_bytes(32, "big"))])
    return builder


def _split(P):
    return P.settings.SplitDb(P.MemDb(), P.MemDb())


# -- tests/test_storage_v2.py -------------------------------------------------


def _routing(P, d, builder):
    f1 = synced_factory(P, P.MemDb(), builder, 4)
    split = _split(P)
    f2 = synced_factory(P, split, builder, 4)
    with split.aux.tx() as aux_tx, split.main.tx() as main_tx:
        for t in P.settings.V2_TABLES:
            assert aux_tx.entry_count(t) > 0, t
            assert main_tx.entry_count(t) == 0, t
        assert main_tx.entry_count(P.Tables.Headers.name) > 0
        assert aux_tx.entry_count(P.Tables.Headers.name) == 0
    history = []
    for n in range(0, 4):
        with f1.provider() as p1, f2.provider() as p2:
            h1 = P.historical.HistoricalStateProvider(p1, n).account(b"\x0b" * 20)
            h2 = P.historical.HistoricalStateProvider(p2, n).account(b"\x0b" * 20)
            assert h1 == h2, n
            history.append(None if h1 is None else (h1.nonce, h1.balance))
    with f2.provider() as p:
        lookup = p.tx.get(P.Tables.TransactionHashNumbers.name,
                          builder.blocks[1].transactions[0].hash)
    assert lookup is not None
    return history, lookup, tables_of(split.main), tables_of(split.aux)


def test_split_routing_and_both_layout_history(tmp_path, v2_chain):
    both(_routing, tmp_path, v2_chain)


def _settings_persist(P, d):
    T = P.Tables
    db = P.storage.open_database("memdb", d, storage_v2=True)
    assert isinstance(db, P.settings.SplitDb)
    assert P.settings.read_settings(db.main) == P.settings.StorageSettings(storage_v2=True)
    db.flush()
    assert isinstance(P.storage.open_database("memdb", d), P.settings.SplitDb)
    other = d / "other"
    other.mkdir()
    dbv1 = P.storage.open_database("memdb", other)
    assert not isinstance(dbv1, P.settings.SplitDb)
    tx = dbv1.tx_mut()
    tx.put(T.CanonicalHeaders.name, P.tables.be64(0), b"\x00" * 32)
    tx.commit()
    dbv1.flush()
    with pytest.raises(ValueError, match="v1 layout") as err:
        P.storage.open_database("memdb", other, storage_v2=True)
    assert not isinstance(P.storage.open_database("memdb", other), P.settings.SplitDb)
    return (str(err.value), {f.name: f.read_bytes() for f in sorted(d.iterdir()) if f.is_file()},
            P.storage.DB_STORES, P.storage.store_initialised("memdb", other))


def test_settings_persist_per_datadir(tmp_path):
    both(_settings_persist, tmp_path)


def _clean_restart(P, d, builder):
    split = _split(P)
    factory = synced_factory(P, split, builder, 4)
    with factory.provider_rw() as p:
        p.save_stage_checkpoint("TransactionLookup", 1)  # mid-sync shape
    assert P.settings.check_consistency(factory) is None
    with factory.provider() as p:
        for blk in builder.blocks[1:]:
            for tx in blk.transactions:
                assert p.tx.get(P.Tables.TransactionHashNumbers.name, tx.hash) is not None
    return tables_of(split.aux)


def test_clean_restart_skips_heavy_checks_and_keeps_rows(tmp_path, v2_chain):
    both(_clean_restart, tmp_path, v2_chain)


def _heal_torn(P, d, builder):
    T, be64, S = P.Tables, P.tables.be64, P.settings
    split = _split(P)
    factory = synced_factory(P, split, builder, 4)
    tip = len(builder.blocks) - 1
    with factory.provider_rw() as p:
        idx = p.block_body_indices(tip)
        p.tx.put(T.TransactionHashNumbers.name, b"\xfa" * 32, be64(idx.next_tx_num + 7))
        p.tx.put(T.AccountChangeSets.name, be64(tip + 1), b"\x0b" * 20 + b"", dupsort=True)
        tail = be64((1 << 64) - 1)
        raw = p.tx.get(T.AccountsHistory.name, b"\x0b" * 20 + tail)
        p.tx.put(T.AccountsHistory.name, b"\x0b" * 20 + tail, (raw or b"") + be64(tip + 1))
    tx = split.aux.tx_mut()
    tx.put(T.Metadata.name, S._EPOCH_KEY, be64(S._read_epoch(split.aux) + 1))
    tx.commit()
    assert S._read_epoch(split.aux) != S._read_epoch(split.main)
    assert S.check_consistency(factory) is None
    with factory.provider() as p:
        assert p.tx.get(T.TransactionHashNumbers.name, b"\xfa" * 32) is None
        assert not p.tx.get_dups(T.AccountChangeSets.name, be64(tip + 1))
        raw = p.tx.get(T.AccountsHistory.name, b"\x0b" * 20 + be64((1 << 64) - 1))
        blocks = [int.from_bytes(raw[i:i + 8], "big") for i in range(0, len(raw or b""), 8)]
        assert all(b <= tip for b in blocks), blocks
    assert S._read_epoch(split.aux) == S._read_epoch(split.main)
    return blocks, tables_of(split.main), tables_of(split.aux)


def test_invariants_heal_torn_commit(tmp_path, v2_chain):
    both(_heal_torn, tmp_path, v2_chain)


def _aux_behind(P, d, builder):
    split = _split(P)
    factory = synced_factory(P, split, builder, 4)
    with factory.provider_rw() as p:
        for tx in builder.blocks[-1].transactions:
            p.tx.delete(P.Tables.TransactionHashNumbers.name, tx.hash)
    target = P.settings.check_consistency(factory)
    assert target == len(builder.blocks) - 2
    return target


def test_invariants_detect_aux_behind(tmp_path, v2_chain):
    both(_aux_behind, tmp_path, v2_chain)


# -- tests/test_history.py ----------------------------------------------------


def _initcode_for(runtime: bytes) -> bytes:
    n = len(runtime)
    return bytes([0x60, n, 0x60, 0x0B, 0x5F, 0x39, 0x60, n, 0x5F, 0xF3]) + b"\x00" + runtime


@pytest.fixture(scope="module")
def history_chain():
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)}, committer=_committer())
    contract = keccak256(rlp_encode([alice.address, encode_int(0)]))[12:]
    builder.build_block([alice.deploy(_initcode_for(STORE))])               # 1
    builder.build_block([alice.call(contract, (0x11).to_bytes(32, "big"))])  # 2
    builder.build_block([alice.transfer(b"\x0b" * 20, 777)])                # 3
    builder.build_block([alice.call(contract, (0x22).to_bytes(32, "big"))])  # 4
    builder.build_block([])                                                 # 5
    return builder, alice.address, contract


def _history_env(P, builder):
    factory = P.ProviderFactory(P.MemDb())
    init_genesis(P, factory, builder)
    P.import_chain(factory, [P.block(b) for b in builder.blocks[1:]], P.consensus())
    pipeline = P.Pipeline(factory, P.stages())
    pipeline.run(5)
    return factory, pipeline


def _account_values(P, d, env):
    builder, alice, _ = env
    factory, _ = _history_env(P, builder)
    p = factory.provider()
    nonces = []
    for block in range(6):
        acc = P.historical.HistoricalStateProvider(p, block).account(alice)
        nonces.append(acc.nonce if acc else 0)
    assert nonces == [0, 1, 2, 3, 4, 4]
    bob = b"\x0b" * 20
    assert P.historical.HistoricalStateProvider(p, 2).account(bob) is None
    assert P.historical.HistoricalStateProvider(p, 3).account(bob).balance == 777
    return nonces


def test_historical_account_values(tmp_path, history_chain):
    both(_account_values, tmp_path, history_chain)


def _storage_values(P, d, env):
    builder, _, contract = env
    factory, _ = _history_env(P, builder)
    p = factory.provider()
    values = [P.historical.HistoricalStateProvider(p, n).storage(contract, b"\x00" * 32)
              for n in range(1, 6)]
    assert values == [0, 0x11, 0x11, 0x22, 0x22]
    return values


def test_historical_storage_values(tmp_path, history_chain):
    both(_storage_values, tmp_path, history_chain)


def _history_unwind(P, d, env):
    builder, alice, _ = env
    factory, pipeline = _history_env(P, builder)
    pipeline.unwind(2)
    p = factory.provider()
    from_port = P is PORT
    ih = (__import__("reth_tpu_torch.stages.index_history" if from_port
                     else "reth_tpu.stages.index_history", fromlist=["x"]))
    assert ih.first_change_after(p, P.Tables.AccountsHistory.name, alice, 2) is None
    pipeline.run(5)
    p = factory.provider()
    assert P.historical.HistoricalStateProvider(p, 3).account(b"\x0b" * 20).balance == 777
    return tables_of(factory.db)


def test_history_unwind(tmp_path, history_chain):
    both(_history_unwind, tmp_path, history_chain)


def _shards(P, d):
    ih = __import__("reth_tpu_torch.stages.index_history" if P is PORT
                    else "reth_tpu.stages.index_history", fromlist=["x"])
    factory = P.ProviderFactory(P.MemDb())
    T = P.Tables
    with factory.provider_rw() as p:
        ih._append_to_shards(p, T.AccountsHistory.name, b"\xaa" * 20,
                             list(range(1, ih.SHARD_CAP * 2 + 50)))
        found = [ih.first_change_after(p, T.AccountsHistory.name, b"\xaa" * 20, n)
                 for n in (0, ih.SHARD_CAP, ih.SHARD_CAP * 2 + 49)]
    assert found == [1, ih.SHARD_CAP + 1, None]
    return found, tables_of(factory.db)


def test_shard_splitting(tmp_path):
    both(_shards, tmp_path)


def _engine_history(P, d, builder):
    factory = P.ProviderFactory(P.MemDb())
    init_genesis(P, factory, builder)
    tree = P.tree(factory, persistence_threshold=2)
    for blk in builder.blocks[1:]:
        assert tree.on_new_payload(P.block(blk)).status is P.Status.VALID
        tree.on_forkchoice_updated(blk.hash)
    assert tree.persisted_number == 3  # 4, 5 in memory

    def balance(n: int) -> int:
        # rpc/eth.py _state_at: the overlay at the tip, else history over it
        p = tree.overlay_provider()
        view = p if n == p.last_block_number() else P.historical.HistoricalStateProvider(p, n)
        acc = view.account(b"\x0b" * 20)
        return acc.balance if acc else 0

    got = [balance(n) for n in range(1, 6)]
    assert got[:2] == [100, 201] and got[3] == 100 + 101 + 102 + 103
    return got


@pytest.fixture(scope="module")
def transfer_chain():
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)}, committer=_committer())
    for i in range(5):
        builder.build_block([alice.transfer(b"\x0b" * 20, 100 + i)])
    return builder


def test_historical_via_engine_persistence(tmp_path, transfer_chain):
    both(_engine_history, tmp_path, transfer_chain)


# -- tests/test_aux.py, test_aux2.py ------------------------------------------


def _synced6(P, builder):
    return synced_factory(P, P.MemDb(), builder, 5)


def _pruner(P, d, builder):
    factory = _synced6(P, builder)
    pr = P.prune
    modes = pr.PruneModes(receipts=pr.PruneMode(distance=2),
                          sender_recovery=pr.PruneMode(distance=2),
                          transaction_lookup=pr.PruneMode(before=3))
    progress = pr.Pruner(factory, modes).run(tip=5)
    p = factory.provider()
    assert p.receipt(0) is None and p.sender(0) is None
    assert p.receipt(p.block_body_indices(4).first_tx_num) is not None
    T = P.Tables
    assert p.tx.get(T.TransactionHashNumbers.name, p.transactions_by_block(1)[0].hash) is None
    assert p.tx.get(T.TransactionHashNumbers.name,
                    p.transactions_by_block(4)[0].hash) is not None
    assert pr.Pruner(factory, modes).run(tip=5) == []
    return [(g.segment, g.pruned, g.done) for g in progress], tables_of(factory.db)


def test_pruner_receipts_and_senders(tmp_path, transfer_chain):
    got = both(_pruner, tmp_path, transfer_chain)[0]
    assert {g[0] for g in got} == {"SenderRecovery", "Receipts", "TransactionLookup"}


def _static_producer(P, d, builder):
    factory = _synced6(P, builder)
    producer = P.static_files.StaticFileProducer(factory, d / "static")
    moved = producer.run(to_block=3)
    assert moved == {"headers": 4, "transactions": 3, "receipts": 3}
    p = factory.provider()
    assert p.tx.get(P.Tables.Transactions.name, P.tables.be64(0)) is None
    factory2 = P.ProviderFactory(factory.db, producer.static)
    p2 = factory2.provider()
    txs = p2.transactions_by_block(1)
    assert len(txs) == 1 and txs[0].value == 100
    receipt = p2.receipt(0)
    assert receipt is not None
    moved2 = producer.run(to_block=5)
    assert moved2["headers"] == 2
    assert factory2.provider().transactions_by_block(5)[0].value == 104
    jars = {f.name: f.read_bytes() for f in sorted((d / "static").glob("*.sf"))}
    return moved, moved2, [t.hash for t in txs], P.tables.encode_receipt(receipt), jars


def test_static_file_producer_and_fallback(tmp_path, transfer_chain):
    both(_static_producer, tmp_path, transfer_chain)


def _tiers(P, d):
    rng = random.Random(3)
    hashes = [rng.randbytes(32) for _ in range(40)]
    blobs = [b"A" * 600 + bytes([i]) for i in range(40)]
    path = d / "seg_0_39.sf"
    P.static_files.write_segment_file(path, "headers", 0, {"hash": hashes, "header": blobs})
    sf = P.static_files.SegmentFile.open(path)
    codecs = dict(sf._jar._codecs)
    assert codecs["hash"] == "none" and codecs["header"] in ("zlib", "lzma")
    for i in (0, 17, 39):
        assert sf.row(i, "hash") == hashes[i] and sf.row(i, "header") == blobs[i]
    sf.close()
    header = json.dumps({"segment": "headers", "start": 0, "count": 2,
                         "columns": ["header"]}).encode()
    payload = [zlib.compress(r) for r in (b"old-one", b"old-two")]
    offs = [0, len(payload[0]), len(payload[0]) + len(payload[1])]
    (d / "legacy_0_1.sf").write_bytes(P.nippyjar.LEGACY_MAGIC + struct.pack("<I", len(header))
                                      + header + struct.pack("<3Q", *offs) + b"".join(payload))
    old = P.static_files.SegmentFile.open(d / "legacy_0_1.sf")
    rows = [old.row(0, "header"), old.row(1, "header")]
    old.close()
    assert rows == [b"old-one", b"old-two"]
    return codecs, rows, path.read_bytes()


def test_static_file_compression_tiers(tmp_path):
    both(_tiers, tmp_path)


def _jar_roundtrip(P, d):
    rng = random.Random(4)
    cols = {"k": [rng.randbytes(32) for _ in range(25)],
            "v": [b"payload-" * 40 + bytes([i]) for i in range(25)]}
    path = d / "data.jar"
    P.nippyjar.NippyJar.write(path, cols, metadata={"purpose": "test", "epoch": 7})
    jar = P.nippyjar.NippyJar.open(path)
    assert jar.count == 25 and jar.columns == ["k", "v"]
    assert jar.metadata == {"purpose": "test", "epoch": 7}
    assert jar.row("k", 13) == cols["k"][13]
    assert list(jar.column_rows("v")) == cols["v"]
    assert jar.verify() is True
    with pytest.raises(IndexError):
        jar.row("k", 25)
    jar.close()
    written = path.read_bytes()
    raw = bytearray(written)
    raw[-3] ^= 0xFF
    path.write_bytes(bytes(raw))
    jar2 = P.nippyjar.NippyJar.open(path)
    assert jar2.verify() is False
    jar2.close()
    return written


def test_nippyjar_standalone_roundtrip(tmp_path):
    both(_jar_roundtrip, tmp_path)


# -- files written by one package, read by the other --------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_jars_and_wal_segments_read_across_packages(tmp_path, transfer_chain, writer):
    """Jars from one package's static-file producer serve the other's
    provider, and its WAL replays in the other into the same tables."""
    W, R = (REF, PORT) if writer == "reference" else (PORT, REF)
    d = tmp_path / "w"
    d.mkdir()
    db, dur = reopen(W, d)
    factory = synced_factory(W, db, transfer_chain, 5)
    W.static_files.StaticFileProducer(factory, d / "static").run(to_block=3)
    want_tables = tables_of(db)
    with factory.provider() as p:
        want_txs = [[t.hash for t in W.ProviderFactory(db, W.static_files.StaticFileProvider(
            d / "static")).provider().transactions_by_block(n)] for n in range(1, 6)]
    assert dur.replay_report()["records"] == 0 and dur.snapshot()["appends"] > 0
    db2, dur2 = reopen(R, d)  # the image was never flushed: all from the WAL
    assert dur2.replay_report()["records"] == dur.snapshot()["appends"]
    assert tables_of(db2) == want_tables
    static = R.static_files.StaticFileProvider(d / "static")
    p2 = R.ProviderFactory(db2, static).provider()
    assert [[t.hash for t in p2.transactions_by_block(n)] for n in range(1, 6)] == want_txs
    assert R.tables.encode_receipt(p2.receipt(0)) == W.tables.encode_receipt(W.ProviderFactory(
        db, W.static_files.StaticFileProvider(d / "static")).provider().receipt(0))
