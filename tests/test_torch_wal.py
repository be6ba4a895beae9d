"""The port's write-ahead log, checkpoints and startup recovery
(``reth_tpu_torch/storage/{wal,kv,nippyjar,recovery}.py``, ``chaos.py``)
against the JAX package's.

Every case of ``tests/test_wal_recovery.py`` that needs no ``Node`` is one
scenario here, run on both packages in directories of their own
(``_torch_storage_pkgs.both``): the replay reports, WAL snapshots, recovered
tables and recovery reports are held equal, tolerance zero, less wall times
and absolute paths. A "crash" is what the reference's tests make it: the live
objects are abandoned (no stop, no flush) and fresh ones open the bytes on
disk. The datadir cases check that both packages write the same bytes (WAL
segments, the manifest less its ``written_at`` time, NippyJars, the ``MemDb``
image) and that a datadir written by either recovers in the other. One case
kills a child that imports only ``reth_tpu_torch`` at the ``"unwind"`` crash
point of a real deep-reorg unwind and heals the datadir with each package.

The port's recovery hashes on numpy (``np_committer``) unless a case says it
takes the card route's plain versions (``TrieCommitter(device="cpu")``).
"""

from __future__ import annotations

import errno
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import pytest

from _torch_block_pkgs import ref_committer
from _torch_storage_pkgs import (
    PORT,
    REF,
    Account,
    ChainBuilder,
    Wallet,
    both,
    init_genesis,
    reopen,
    scrub,
    tables_of,
)
from reth_tpu_torch.metrics import recovery_metrics
from reth_tpu_torch.trie.committer import TrieCommitter

REPO = Path(__file__).resolve().parent.parent


def _seg(d: Path, gen: int = 1) -> Path:
    return d / "wal" / f"{gen:08d}.wal"


# -- record format ------------------------------------------------------------


def _roundtrip(P, d):
    db, dur = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
        tx.put("D", b"k", b"x", dupsort=True)
        tx.put("D", b"k", b"y", dupsort=True)
    with db.tx_mut() as tx:
        tx.delete("T", b"a")
        tx.put("T", b"b", b"2")
        tx.delete("D", b"k", b"x")
    snap = dur.snapshot()
    db2, dur2 = reopen(P, d)
    with db2.tx() as t:
        assert t.get("T", b"a") is None
        assert t.get("T", b"b") == b"2"
        assert t.get_dups("D", b"k") == [b"y"]
    rep = dur2.replay_report()
    assert rep["records"] == 2 and rep["torn_bytes"] == 0
    return snap, rep, tables_of(db2), _seg(d).read_bytes()


def test_wal_commit_replay_roundtrip(tmp_path):
    both(_roundtrip, tmp_path)


def _clear(P, d):
    db, _ = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
        tx.put("T", b"b", b"2")
    with db.tx_mut() as tx:
        tx.clear("T")
        tx.put("T", b"c", b"3")
    db2, dur2 = reopen(P, d)
    with db2.tx() as t:
        assert t.get("T", b"a") is None
        assert t.get("T", b"c") == b"3"
        assert t.entry_count("T") == 1
    return dur2.replay_report(), tables_of(db2), _seg(d).read_bytes()


def test_wal_clear_records_whole_table_replace(tmp_path):
    both(_clear, tmp_path)


def _torn_tail(P, d):
    db, dur = reopen(P, d)
    for i in range(3):
        with db.tx_mut() as tx:
            tx.put("T", bytes([i]), b"v%d" % i)
    seg = dur.main.dir / "00000001.wal"
    seg.write_bytes(seg.read_bytes()[:-7])  # truncated mid-record
    db2, dur2 = reopen(P, d)
    rep = dur2.replay_report()
    assert rep["records"] == 2 and rep["torn_bytes"] > 0
    with db2.tx() as t:
        assert t.get("T", b"\x00") == b"v0"
        assert t.get("T", b"\x01") == b"v1"
        assert t.get("T", b"\x02") is None
    return rep, dur2.snapshot(), tables_of(db2)


def test_wal_torn_tail_discarded(tmp_path):
    both(_torn_tail, tmp_path)


def _torn_then_commit(P, d):
    """Crash -> recover -> commit -> crash again: recovery truncates the torn
    tail off the live segment, so the post-recovery commit replays."""
    db, dur = reopen(P, d)
    for i in range(3):
        with db.tx_mut() as tx:
            tx.put("T", bytes([i]), b"v%d" % i)
    seg = dur.main.dir / "00000001.wal"
    seg.write_bytes(seg.read_bytes()[:-7])
    db2, dur2 = reopen(P, d)
    assert dur2.replay_report()["records"] == 2
    size = seg.stat().st_size
    with db2.tx_mut() as tx:
        tx.put("T", b"new", b"post-recovery")
    assert seg.stat().st_size > size
    db3, dur3 = reopen(P, d)
    rep = dur3.replay_report()
    assert rep["records"] == 3 and rep["torn_bytes"] == 0
    with db3.tx() as t:
        assert t.get("T", b"new") == b"post-recovery"
        assert t.get("T", b"\x02") is None
    return size, rep, tables_of(db3), seg.read_bytes()


def test_torn_tail_truncated_so_post_recovery_commits_survive(tmp_path):
    both(_torn_then_commit, tmp_path)


def _midlog(P, d):
    db, dur = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    with db.tx_mut() as tx:
        tx.put("T", b"b", b"2")
    dur.main.close()
    payload = pickle.dumps(
        {"seq": 9, "tables": {"T": {"rows": {b"c": b"3"}, "del": []}}},
        protocol=pickle.HIGHEST_PROTOCOL)
    seg2 = _seg(d, 2)
    seg2.write_bytes(P.wal.SEGMENT_MAGIC + struct.pack("<Q", 2)
                     + struct.pack("<II", len(payload), zlib.crc32(payload)) + payload)
    seg1 = _seg(d, 1)
    data = bytearray(seg1.read_bytes())
    data[-1] ^= 0xFF  # the second record of segment 1: mid-log now
    seg1.write_bytes(bytes(data))

    db2, dur2 = reopen(P, d)
    rep = dur2.replay_report()
    assert len(rep["lost_segments"]) == 2
    assert not seg1.exists() and not seg2.exists()
    assert (d / "wal" / "00000001.wal.corrupt").exists()
    assert (d / "wal" / "00000002.wal.corrupt").exists()
    with db2.tx() as t:
        assert t.get("T", b"a") == b"1" and t.get("T", b"c") is None
    report = P.recover(P.ProviderFactory(db2), durability=dur2, verify_root=False)
    assert report["status"] == "failed"
    assert any("mid-log" in p for p in report["problems"])
    assert any(".wal.corrupt" in q for q in report["quarantined"])
    db3, dur3 = reopen(P, d)
    rep3 = dur3.replay_report()
    assert rep3["torn_bytes"] == 0 and not rep3["lost_segments"]
    assert dur3.main.gen >= 3
    return rep, report, rep3, dur3.main.gen, tables_of(db3)


def test_midlog_corruption_quarantines_segments_and_escalates(tmp_path):
    both(_midlog, tmp_path)


def _append_failure(P, d, monkeypatch):
    db, dur = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    seg = dur.main.dir / "00000001.wal"
    good_size = seg.stat().st_size
    fail = {"on": True}
    real_fsync = os.fsync

    def flaky(fd):
        if fail["on"]:
            raise OSError(errno.EIO, "injected EIO")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", flaky)
    with pytest.raises(OSError):
        with db.tx_mut() as tx:
            tx.put("T", b"b", b"2")
    fail["on"] = False
    monkeypatch.undo()
    assert seg.stat().st_size == good_size  # the failed record rewound
    with db.tx_mut() as tx:  # the writer lock was released
        tx.put("T", b"c", b"3")
    with db.tx() as t:
        assert t.get("T", b"b") is None
    db2, dur2 = reopen(P, d)
    rep = dur2.replay_report()
    assert rep["records"] == 2 and rep["torn_bytes"] == 0
    return good_size, rep, tables_of(db2)


def test_append_failure_rewinds_log_and_releases_writer_lock(tmp_path, monkeypatch):
    both(_append_failure, tmp_path, monkeypatch)


def _fsync_errors(P, d, monkeypatch):
    seen = []
    with open(d / "x", "wb") as f:
        monkeypatch.setattr(os, "fsync", lambda fd: (_ for _ in ()).throw(
            OSError(errno.EIO, "injected EIO")))
        with pytest.raises(OSError) as err:
            P.wal.fsync_file(f)
        seen.append(err.value.errno)
        monkeypatch.setattr(os, "fsync", lambda fd: (_ for _ in ()).throw(
            OSError(errno.EINVAL, "not supported")))
        P.wal.fsync_file(f)  # "unsupported here" stays best-effort
    monkeypatch.undo()
    return seen


def test_fsync_file_propagates_real_io_errors(tmp_path, monkeypatch):
    assert both(_fsync_errors, tmp_path, monkeypatch) == [errno.EIO]
    from reth_tpu_torch.storage import kv, wal

    # kv.py takes its fsync helpers from wal.py, where the reference keeps them
    assert kv.fsync_file is wal.fsync_file and kv.fsync_dir is wal.fsync_dir


def _gen_mismatch(P, d):
    db, dur = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    dur.main.close()
    renamed = d / "wal" / "00000005.wal"
    _seg(d).rename(renamed)
    records, torn, accepted = P.wal.read_segment(renamed)
    assert records == [] and torn == renamed.stat().st_size
    db2, dur2 = reopen(P, d)
    with db2.tx() as t:
        assert t.get("T", b"a") is None
    return (records, torn, accepted), dur2.replay_report()


def test_segment_gen_mismatch_treated_as_torn(tmp_path):
    both(_gen_mismatch, tmp_path)


def _crc_mismatch(P, d):
    db, dur = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    seg = dur.main.dir / "00000001.wal"
    data = bytearray(seg.read_bytes())
    data[-1] ^= 0xFF
    seg.write_bytes(bytes(data))
    records, torn, accepted = P.wal.read_segment(seg)
    assert records == [] and torn > 0 and accepted == 0
    return records, torn, accepted


def test_wal_crc_mismatch_discards_tail(tmp_path):
    both(_crc_mismatch, tmp_path)


def _accept_torn(P, d, monkeypatch):
    db, _ = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"good")
    evil = {"T": {"rows": {b"a": b"evil"}, "del": []}}
    P.chaos.inject_bad_crc_record(d / "wal", evil)
    db2, dur2 = reopen(P, d)
    with db2.tx() as t:
        assert t.get("T", b"a") == b"good"
    P.chaos.inject_bad_crc_record(d / "wal", evil)
    monkeypatch.setenv("RETH_TPU_FAULT_WAL_ACCEPT_TORN", "1")
    db3, dur3 = reopen(P, d)
    monkeypatch.undo()
    with db3.tx() as t:
        assert t.get("T", b"a") == b"evil"
    assert dur3.replay_report()["accepted_torn"] == 1
    return dur2.replay_report(), dur3.replay_report(), _seg(d).read_bytes()


def test_wal_accept_torn_env_is_deliberately_broken(tmp_path, monkeypatch):
    both(_accept_torn, tmp_path, monkeypatch)


def _magic(P, d):
    _, dur = reopen(P, d)
    raw = (dur.main.dir / "00000001.wal").read_bytes()
    assert raw.startswith(P.wal.SEGMENT_MAGIC)
    return raw, struct.unpack_from("<Q", raw, len(P.wal.SEGMENT_MAGIC))[0]


def test_segment_header_magic(tmp_path):
    assert both(_magic, tmp_path)[1] == 1


# -- checkpointing ------------------------------------------------------------


def _manifest(d: Path) -> dict:
    m = json.loads((d / "wal" / "MANIFEST.json").read_text())
    m.pop("written_at")
    return m


def _checkpoint(P, d):
    db, dur = reopen(P, d)
    for i in range(4):
        with db.tx_mut() as tx:
            tx.put("T", bytes([i]), b"v")
    dur.checkpoint(head=(7, b"\xab" * 32))
    segs = sorted(p.name for p in (d / "wal").glob("*.wal"))
    assert segs == ["00000002.wal"]
    manifest = _manifest(d)
    assert (manifest["gen"], manifest["head_number"], manifest["head_hash"]) == \
        (2, 7, "ab" * 32)
    db2, dur2 = reopen(P, d)
    assert dur2.replay_report()["records"] == 0
    return segs, manifest, dur.snapshot(), tables_of(db2), (d / "db.bin").read_bytes()


def test_checkpoint_truncates_log_and_writes_manifest(tmp_path):
    both(_checkpoint, tmp_path)


def _idempotent(P, d):
    db, _ = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
        tx.put("D", b"k", b"x", dupsort=True)
    with db.tx_mut() as tx:
        tx.delete("T", b"a")
        tx.put("D", b"k", b"y", dupsort=True)
    db.flush()  # image now ahead of the untruncated segment
    db2, dur2 = reopen(P, d)
    with db2.tx() as t:
        assert t.get("T", b"a") is None
        assert t.get_dups("D", b"k") == [b"x", b"y"]
    return dur2.replay_report(), tables_of(db2)


def test_replay_idempotent_over_newer_image(tmp_path):
    both(_idempotent, tmp_path)


def _cadence(P, d):
    db, dur = reopen(P, d)
    dur.checkpoint_blocks = 3
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    gens = []
    for n in (1, 2, 4):
        dur.on_persisted(n, bytes([n]) * 32)
        gens.append(dur.main.gen)
    assert gens[1] == gens[0] and gens[2] == gens[0] + 1
    return gens, dur.snapshot(), _manifest(d)


def test_checkpoint_cadence_tracks_persisted_blocks(tmp_path):
    both(_cadence, tmp_path)


def _split_wals(P, d):
    T = P.Tables
    split = P.settings.SplitDb(P.MemDb(d / "db.bin"), P.MemDb(d / "db-aux.bin"))
    dur = P.attach_wal(split, d / "wal")
    assert dur is not None and len(dur.stores) == 2
    with split.tx_mut() as tx:
        tx.put(T.Headers.name, b"\x00" * 8, b"hdr")
        tx.put(T.AccountsHistory.name, b"\xaa", b"shard")
    split2 = P.settings.SplitDb(P.MemDb(d / "db.bin"), P.MemDb(d / "db-aux.bin"))
    dur2 = P.attach_wal(split2, d / "wal")
    with split2.tx() as t:
        assert t.get(T.Headers.name, b"\x00" * 8) == b"hdr"
        assert t.get(T.AccountsHistory.name, b"\xaa") == b"shard"
    assert (d / "wal-aux").is_dir()
    return (dur2.replay_report(), dur2.snapshot(), tables_of(split2.main),
            tables_of(split2.aux), _seg(d).read_bytes(),
            (d / "wal-aux" / "00000001.wal").read_bytes())


def test_storage_v2_split_store_gets_two_wals(tmp_path):
    both(_split_wals, tmp_path)


# -- fsync durability ---------------------------------------------------------


def _count_fsyncs(monkeypatch):
    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
    return calls


def _flush_fsyncs(P, d, monkeypatch):
    db = P.MemDb(d / "db.bin")
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    calls = _count_fsyncs(monkeypatch)
    db.flush()
    monkeypatch.undo()
    assert len(calls) >= 2  # the tmp file and the parent directory
    return len(calls), (d / "db.bin").read_bytes()


def test_memdb_flush_fsyncs_file_and_parent_dir(tmp_path, monkeypatch):
    both(_flush_fsyncs, tmp_path, monkeypatch)


def _jar_fsyncs(P, d, monkeypatch):
    calls = _count_fsyncs(monkeypatch)
    P.nippyjar.NippyJar.write(d / "x.sf", {"c": [b"row1", b"row2"]})
    monkeypatch.undo()
    assert len(calls) >= 2
    assert not list(d.glob("*.tmp"))
    jar = P.nippyjar.NippyJar.open(d / "x.sf")
    assert jar.verify() and jar.row("c", 1) == b"row2"
    jar.close()
    return len(calls), (d / "x.sf").read_bytes()


def test_nippyjar_write_fsyncs_file_and_parent_dir(tmp_path, monkeypatch):
    both(_jar_fsyncs, tmp_path, monkeypatch)


def _append_order(P, d, monkeypatch):
    db, _ = reopen(P, d)
    order = []
    real_append = P.wal.WalStore.append

    def spy(self, delta, publish=None):
        def wrapped():
            order.append("publish")
            publish()
        order.append("append")
        real_append(self, delta, publish=wrapped if publish else None)

    monkeypatch.setattr(P.wal.WalStore, "append", spy)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"1")
    monkeypatch.undo()
    return order


def test_wal_append_fsyncs_before_publish(tmp_path, monkeypatch):
    assert both(_append_order, tmp_path, monkeypatch) == ["append", "publish"]


# -- corrupt-image quarantine -------------------------------------------------


def _quarantine(P, d):
    (d / "db.bin").write_bytes(b"\x80\x04this is not a pickle")
    db = P.MemDb(d / "db.bin")  # must not raise
    assert db.quarantined is not None and db.quarantined.exists()
    assert not (d / "db.bin").exists()
    with db.tx() as t:
        assert t.entry_count("T") == 0
    return db.quarantined


def test_corrupt_image_quarantined_not_fatal(tmp_path):
    both(_quarantine, tmp_path)


def _image_from_wal(P, d):
    db, _ = reopen(P, d)
    with db.tx_mut() as tx:
        tx.put("T", b"a", b"survives")
    (d / "db.bin").write_bytes(b"junk")
    db2, dur2 = reopen(P, d)
    assert db2.quarantined is not None
    with db2.tx() as t:
        assert t.get("T", b"a") == b"survives"
    report = P.recover(P.ProviderFactory(db2), durability=dur2)
    return db2.quarantined, dur2.replay_report(), report


def test_corrupt_image_recovers_from_wal(tmp_path):
    both(_image_from_wal, tmp_path)


# -- metrics ------------------------------------------------------------------

_WAL_COUNTERS = ("wal_appends_total", "wal_bytes_written_total", "wal_checkpoints_total",
                 "recovery_wal_records_replayed_total", "recovery_torn_bytes_total",
                 "recovery_quarantined_total")


def _wal_metrics(P, d):
    """What the WAL and recovery record into the process registry: the
    counters' moves, the gauges and the recovery's events-line fragment."""
    reg = P.metrics.REGISTRY
    before = {n: reg.counter(n).value for n in _WAL_COUNTERS}
    db, dur = reopen(P, d)
    for i in range(3):
        with db.tx_mut() as tx:
            tx.put("T", bytes([i]), b"v" * i)
    dur.checkpoint(head=(1, b"\x01" * 32))
    with db.tx_mut() as tx:
        tx.put("T", b"x", b"y")
    seg = d / "wal" / "00000002.wal"
    seg.write_bytes(seg.read_bytes()[:-3])
    db2, dur2 = reopen(P, d)
    P.recover(P.ProviderFactory(db2), durability=dur2, verify_root=False)
    moved = {n: reg.counter(n).value - before[n] for n in _WAL_COUNTERS}
    gauges = {n: reg.gauge(n).value for n in ("wal_generation", "wal_segment_bytes",
                                              "recovery_status", "recovery_problems")}
    last = {k: v for k, v in P.metrics.wal_metrics.last_recovery.items() if k != "wall_s"}
    return moved, gauges, last


def test_wal_and_recovery_metrics_match_reference(tmp_path):
    moved, gauges, last = both(_wal_metrics, tmp_path)
    assert moved["wal_appends_total"] == 4 and moved["wal_checkpoints_total"] == 1
    assert moved["recovery_torn_bytes_total"] > 0 and gauges["recovery_status"] == 1
    assert last["status"] == "degraded"


# -- node-level crash windows, without a node ---------------------------------


def _transfer_chain(n: int, fork_at: int | None = None):
    """``n`` blocks of one transfer each from one wallet (the reference's
    own); with ``fork_at``, also a fork block on block ``fork_at - 1``."""
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)},
                           committer=ref_committer())
    for i in range(n):
        builder.build_block([alice.transfer(b"\xaa" * 20, 100 + i)])
    fork = None
    if fork_at is not None:
        alice_b = Wallet(0xA11CE)
        builder_b = ChainBuilder({alice_b.address: Account(balance=10**21)},
                                 committer=ref_committer())
        for i in range(fork_at - 1):
            builder_b.build_block([alice_b.transfer(b"\xaa" * 20, 100 + i)])
        fork = builder_b.build_block([alice_b.transfer(b"\xbb" * 20, 999)], timestamp=900)
        assert fork.header.parent_hash == builder.blocks[fork_at - 1].hash
    return builder, fork


@pytest.fixture(scope="module")
def fork_chain():
    return _transfer_chain(6, fork_at=3)


@pytest.fixture(scope="module")
def short_chain():
    return _transfer_chain(5)[0]


def _tree_on_wal(P, d, builder, upto: int | None = None):
    db, dur = reopen(P, d)
    factory = P.ProviderFactory(db)
    init_genesis(P, factory, builder)
    tree = P.tree(factory, persistence_threshold=1)
    tree.durability = dur
    for blk in builder.blocks[1:(upto or len(builder.blocks) - 1) + 1]:
        assert tree.on_new_payload(P.block(blk)).status is P.Status.VALID
        tree.on_forkchoice_updated(blk.hash)
    return db, dur, factory, tree


def _reorg_across_restart(P, d, chain):
    builder, fork3 = chain
    _, _, _, tree = _tree_on_wal(P, d, builder)
    assert tree.persisted_number == 5
    assert tree.on_new_payload(P.block(fork3)).status is not P.Status.INVALID
    assert tree.on_forkchoice_updated(fork3.hash).status is P.Status.VALID
    assert tree.persisted_number == 2
    db2, dur2 = reopen(P, d)
    factory2 = P.ProviderFactory(db2)
    report = P.recover(factory2, durability=dur2)
    assert report["status"] in ("ok", "degraded") and report["root_verified"] is True
    tree2 = P.tree(factory2, persistence_threshold=1)
    tree2.durability = dur2
    assert tree2.persisted_number == 2
    assert tree2.persisted_hash == builder.blocks[2].hash
    assert tree2.on_new_payload(P.block(fork3)).status is P.Status.VALID
    assert tree2.on_forkchoice_updated(fork3.hash).status is P.Status.VALID
    assert tree2.head_hash == fork3.hash
    return report, dur2.snapshot(), tables_of(db2)


def test_reorg_across_restart(tmp_path, fork_chain):
    both(_reorg_across_restart, tmp_path, fork_chain)


def _interrupted_unwind(P, d, builder, recover=None):
    T = P.Tables
    _, _, factory, tree = _tree_on_wal(P, d, builder)
    assert tree.persisted_number == 4
    # the crash window: marker and pipeline unwind committed, no surgery
    with factory.provider_rw() as p:
        p.tx.put(T.Metadata.name, P.UNWIND_MARKER_KEY, (2).to_bytes(8, "big"))
    P.Pipeline(factory, P.stages()).unwind(2)
    db2, dur2 = reopen(P, d)
    factory2 = P.ProviderFactory(db2)
    report = (recover or P.recover)(factory2, durability=dur2)
    assert any("completed interrupted unwind" in h for h in report["healed"])
    assert report["status"] == "degraded"
    assert report["head_number"] == 2 and report["root_verified"] is True
    with factory2.provider() as p:
        assert p.last_block_number() == 2
        assert p.tx.get(T.Metadata.name, P.UNWIND_MARKER_KEY) is None
    return report, tables_of(db2)


def test_interrupted_unwind_healed_on_restart(tmp_path, short_chain):
    both(_interrupted_unwind, tmp_path, short_chain)


def test_interrupted_unwind_healed_on_the_card_route(tmp_path, short_chain):
    """The same heal with the port's recovery building its own committers on
    ``device="cpu"``: the unwind's stages and the root check on kernels 1-3's
    plain versions, equal to the reference's numpy heal."""
    ref = scrub(_interrupted_unwind(REF, _mk(tmp_path / "ref"), short_chain), tmp_path / "ref")
    d = _mk(tmp_path / "port")
    got = _interrupted_unwind(PORT, d, short_chain, recover=lambda f, **kw: (
        PORT.recovery.recover_on_startup(f, device="cpu", **kw)))
    assert scrub(got, d) == ref


def _mk(d: Path) -> Path:
    d.mkdir()
    return d


def _torn_acceptance(P, d, builder, monkeypatch, value: bytes):
    """The port of the reference's node case without a node: the chain
    driven through a tree with the WAL attached, then a bad-CRC record that
    rewrites one hashed account with ``value``. The correct reader discards
    it and the root verifies; the broken reader applies it and the root
    check fails: "root verification crashed" where ``value`` is no account
    (the reference's record; the port counts the crash in ``fallbacks``),
    "state root mismatch" where it is another account."""
    T = P.Tables
    _tree_on_wal(P, d, builder)
    victim = P.keccak.keccak256_batch_np([Wallet(0xA11CE).address])[0]
    evil = {T.HashedAccounts.name: {"rows": {bytes(victim): value}, "del": []}}
    P.chaos.inject_bad_crc_record(d / "wal", evil)
    db2, dur2 = reopen(P, d)
    report = P.recover(P.ProviderFactory(db2), durability=dur2)
    assert report["status"] in ("ok", "degraded") and report["root_verified"] is True
    P.chaos.inject_bad_crc_record(d / "wal", evil)
    monkeypatch.setenv("RETH_TPU_FAULT_WAL_ACCEPT_TORN", "1")
    db3, dur3 = reopen(P, d)
    monkeypatch.undo()
    report3 = P.recover(P.ProviderFactory(db3), durability=dur3)
    assert report3["status"] == "failed" and report3["root_verified"] is False
    crashed = any("root verification crashed" in p for p in report3["problems"])
    assert crashed or any("state root mismatch" in p for p in report3["problems"])
    if P is PORT:
        assert report3.pop("fallbacks") == ({"verify": 1} if crashed else {})
    return report, report3


@pytest.mark.parametrize("value", ["reference", "account"])
def test_recovery_detects_corruption_injected_via_torn_acceptance(
        tmp_path, short_chain, monkeypatch, value):
    from reth_tpu.storage.tables import encode_account

    raw = (b"\xde\xad" * 30 if value == "reference"
           else encode_account(Account(nonce=1, balance=12345)))
    report3 = both(_torn_acceptance, tmp_path, short_chain, monkeypatch, raw)[1]
    want = "root verification crashed" if value == "reference" else "state root mismatch"
    assert any(want in p for p in report3["problems"])


def _jar_hygiene(P, d):
    static = d / "static_files"
    static.mkdir()
    P.nippyjar.NippyJar.write(static / "headers_0_1.sf", {"h": [b"a", b"b"]})
    (static / "headers_2_3.sf.tmp").write_bytes(b"half-written")
    raw = bytearray((static / "headers_0_1.sf").read_bytes())
    raw[-1] ^= 0xFF
    (static / "headers_0_1.sf").write_bytes(bytes(raw))
    report = P.recover(P.ProviderFactory(P.MemDb(d / "db.bin")), static_dir=static,
                       verify_root=False)
    assert report["status"] == "degraded"
    assert not (static / "headers_2_3.sf.tmp").exists()
    assert not (static / "headers_0_1.sf").exists()
    assert any("digest" in p for p in report["problems"])
    assert any(q.endswith(".corrupt") for q in report["quarantined"])
    return report


def test_jar_hygiene_quarantines_bad_digest(tmp_path):
    both(_jar_hygiene, tmp_path)


# -- the port's catch-alls ----------------------------------------------------


def _unwound_datadir(d: Path, builder):
    """A port datadir in the unwind crash window (marker at 2, stages unwound,
    headers 3-4 still canonical), reopened."""
    _interrupted_unwind_window(d, builder)
    return reopen(PORT, d)


def _interrupted_unwind_window(d: Path, builder):
    _, _, factory, _ = _tree_on_wal(PORT, d, builder)
    with factory.provider_rw() as p:
        p.tx.put(PORT.Tables.Metadata.name, PORT.UNWIND_MARKER_KEY, (2).to_bytes(8, "big"))


def test_catch_alls_count_other_failures_and_raise_kernel_faults(tmp_path, short_chain,
                                                                 monkeypatch):
    """A departure kept on purpose: the unwind completion and the root check
    keep the reference's catch-alls for causes that are no kernel fault
    (counted in the report's and the metrics' ``fallbacks``) and re-raise a
    kernel fault (``ops/_build.is_kernel_fault``)."""
    from reth_tpu_torch.ops._build import LaunchError
    from reth_tpu_torch.storage import recovery
    from reth_tpu_torch.trie import incremental

    def failing(exc):
        def hasher(msgs):
            raise exc
        return TrieCommitter(hasher=hasher, device="cpu")

    before = dict(recovery_metrics.fallbacks)
    # the unwind completion's catch-all: the heal goes on, the stages stay
    # ragged, so the root is not checked
    db, dur = _unwound_datadir(_mk(tmp_path / "unwind"), short_chain)
    report = recovery.recover_on_startup(PORT.ProviderFactory(db), durability=dur,
                                         committer=failing(ValueError("bad row")),
                                         device="cpu")
    assert report["fallbacks"] == {"unwind": 1}
    assert report["healed"] == ["completed interrupted unwind 4 -> 2"]
    assert report["problems"] == ["unwind completion failed: bad row"]
    assert report["root_verified"] is None
    # the root check's catch-all, on a datadir with nothing to heal
    d = _mk(tmp_path / "verify")
    _tree_on_wal(PORT, d, short_chain)
    db, dur = reopen(PORT, d)
    report = recovery.recover_on_startup(PORT.ProviderFactory(db), durability=dur,
                                         committer=failing(ValueError("bad row")),
                                         device="cpu")
    assert report["fallbacks"] == {"verify": 1}
    assert report["status"] == "failed" and report["root_verified"] is False
    assert report["problems"] == ["root verification crashed: bad row"]
    assert {k: recovery_metrics.fallbacks.get(k, 0) - before.get(k, 0)
            for k in ("unwind", "verify")} == {"unwind": 1, "verify": 1}

    # a launch fault in the unwind's stages raises out of recovery
    db, dur = _unwound_datadir(_mk(tmp_path / "launch"), short_chain)
    with pytest.raises(LaunchError):
        recovery.recover_on_startup(PORT.ProviderFactory(db), durability=dur,
                                    committer=failing(LaunchError("keccak: CUDA error 700")),
                                    device="cpu")
    # and one in the root check, after a healthy unwind
    db, dur = _unwound_datadir(_mk(tmp_path / "verify-launch"), short_chain)
    real = incremental.verify_state_root

    def verify(p, committer=None, device="cuda"):
        raise LaunchError("packed_level: CUDA error 700 at launch")

    monkeypatch.setattr(incremental, "verify_state_root", verify)
    with pytest.raises(LaunchError):
        recovery.recover_on_startup(PORT.ProviderFactory(db), durability=dur,
                                    committer=TrieCommitter(device="cpu"), device="cpu")
    monkeypatch.setattr(incremental, "verify_state_root", real)


# -- datadirs shared between the packages -------------------------------------


def _datadir(P, d, builder, n_blocks: int, jars_to: int):
    """``builder``'s chain synced through ``default_stages`` with a WAL
    attached, then the static-file producer up to ``jars_to`` and a
    checkpoint that pins the jars; returns the files' bytes."""
    db, dur = reopen(P, d)
    dur.static_dir = d / "static_files"
    factory = P.ProviderFactory(db)
    init_genesis(P, factory, builder)
    P.import_chain(factory, [P.block(b) for b in builder.blocks[1:n_blocks + 1]],
                   P.consensus())
    P.Pipeline(factory, P.stages()).run(n_blocks)
    segment = _seg(d).read_bytes()
    moved = P.static_files.StaticFileProducer(factory, d / "static_files").run(to_block=jars_to)
    dur.checkpoint(head=(n_blocks, builder.blocks[n_blocks].hash))
    jars = {p.name: p.read_bytes() for p in sorted((d / "static_files").glob("*.sf"))}
    return dict(segment=segment, moved=moved, manifest=_manifest(d), jars=jars,
                image=(d / "db.bin").read_bytes(), snapshot=dur.snapshot(),
                tables=tables_of(db))


@pytest.fixture(scope="module")
def sync_chain():
    from reth_tpu.primitives.keccak import keccak256

    store = bytes.fromhex("5f355f5500")  # sstore(0, calldata[0])
    caddr = b"\x5a" * 20
    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21),
                            caddr: Account(code_hash=keccak256(store))},
                           codes={keccak256(store): store}, committer=ref_committer())
    for i in range(4):
        builder.build_block([alice.transfer(b"\x0b" * 20, 100 + i),
                             alice.call(caddr, (i + 1).to_bytes(32, "big"))])
    return builder


def test_datadir_bytes_equal_the_reference(tmp_path, sync_chain):
    """One seeded chain synced with a WAL attached and its jars produced: the
    WAL segment, the manifest (less ``written_at``), the jars and the
    checkpointed image are the reference's byte for byte."""
    got = both(_datadir, tmp_path, sync_chain, 4, 2)
    assert got["moved"] == {"headers": 3, "transactions": 4, "receipts": 4}
    assert set(got["jars"]) == {"headers_0_2.sf", "transactions_0_3.sf", "receipts_0_3.sf"}
    assert got["manifest"]["jars"] and got["snapshot"]["checkpoints"] == 1


def _crash_window(P, d, builder):
    """A datadir left in the unwind crash window by package ``P``: synced to 5
    through a tree with the WAL attached, the marker at 2, the pipeline's
    unwind committed, no surgery."""
    _, _, factory, _ = _tree_on_wal(P, d, builder)
    with factory.provider_rw() as p:
        p.tx.put(P.Tables.Metadata.name, P.UNWIND_MARKER_KEY, (2).to_bytes(8, "big"))
    P.Pipeline(factory, P.stages()).unwind(2)


def _recover_copy(P, src: Path, dst: Path):
    shutil.copytree(src, dst)
    db, dur = reopen(P, dst)
    report = P.recover(P.ProviderFactory(db), durability=dur)
    return scrub(report, dst), dur.replay_report(), tables_of(db)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_datadir_recovers_in_either_package(tmp_path, short_chain, writer):
    """A datadir written by one package recovers in the other with the report
    and tables the writer's own recovery gives, ``root_verified`` in both."""
    W = REF if writer == "reference" else PORT
    src = _mk(tmp_path / "src")
    _crash_window(W, src, short_chain)
    ref = _recover_copy(REF, src, tmp_path / "by-ref")
    port = _recover_copy(PORT, src, tmp_path / "by-port")
    assert port == ref
    assert ref[0]["root_verified"] is True and ref[0]["status"] == "degraded"


_CHILD = textwrap.dedent("""
    import pickle, sys
    from pathlib import Path

    sys.path.insert(0, {repo!r})
    from reth_tpu_torch.engine import EngineTree
    from reth_tpu_torch.primitives import keccak, types
    from reth_tpu_torch.storage import MemDb, ProviderFactory
    from reth_tpu_torch.storage.genesis import init_genesis
    from reth_tpu_torch.storage.wal import attach_wal
    from reth_tpu_torch.trie.committer import TrieCommitter

    d = Path({datadir!r})
    spec = pickle.loads(Path({spec!r}).read_bytes())
    committer = TrieCommitter(hasher=keccak.keccak256_batch_np, device="cpu")
    db = MemDb(d / "db.bin")
    dur = attach_wal(db, d / "wal")
    factory = ProviderFactory(db)
    accounts = {{a: types.Account(nonce=n, balance=b) for a, (n, b) in spec["alloc"].items()}}
    init_genesis(factory, types.Header.decode(spec["genesis"]), accounts, committer=committer)
    tree = EngineTree(factory, committer=committer, device="cpu", persistence_threshold=1)
    tree.durability = dur
    for raw in spec["blocks"]:
        blk = types.Block.decode(raw)
        assert tree.on_new_payload(blk).status.value == "VALID"
        tree.on_forkchoice_updated(blk.hash)
    print("persisted", tree.persisted_number, flush=True)
    fork = types.Block.decode(spec["fork"])
    tree.on_new_payload(fork)
    tree.on_forkchoice_updated(fork.hash)  # the deep reorg: dies at "unwind"
    print("survived", flush=True)
""")


def test_child_killed_mid_unwind_heals_in_both_packages(tmp_path, fork_chain):
    """A child that imports only ``reth_tpu_torch`` dies at
    ``RETH_TPU_FAULT_CRASH_AT=unwind`` inside a real deep-reorg unwind (its
    stages unwound, the canonical surgery not run). The port's recovery heals
    the datadir it left, and the result equals the reference's healing of the
    same bytes."""
    builder, fork3 = fork_chain
    src = _mk(tmp_path / "src")
    spec = dict(alloc={a: (acc.nonce, acc.balance) for a, acc in builder.accounts_at_genesis.items()},
                genesis=builder.genesis.encode(),
                blocks=[b.encode() for b in builder.blocks[1:]], fork=fork3.encode())
    (tmp_path / "spec.pkl").write_bytes(pickle.dumps(spec))
    script = _CHILD.format(repo=str(REPO), datadir=str(src), spec=str(tmp_path / "spec.pkl"))
    env = dict(os.environ, RETH_TPU_FAULT_CRASH_AT="unwind")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert "persisted 5" in proc.stdout and "survived" not in proc.stdout
    assert "crash point 'unwind' firing" in proc.stderr
    ref = _recover_copy(REF, src, tmp_path / "by-ref")
    port = _recover_copy(PORT, src, tmp_path / "by-port")
    assert port == ref
    report = ref[0]
    assert report["status"] == "degraded" and report["root_verified"] is True
    assert report["healed"] == ["completed interrupted unwind 5 -> 2"]
    assert report["head_number"] == 2
