"""The port's native KV engines (``reth_tpu_torch/storage/native.py`` on
``csrc/kvstore.cpp`` and ``csrc/pagedkv.cpp``) against the JAX package's.

The cases of ``tests/test_native_kv.py``, ``test_paged_kv.py``,
``test_mvcc.py`` and ``test_storage.py``'s backend-parametrised contract run
on both packages (``_torch_storage_pkgs.both``) with the same data, made from
a seed, and their observations are held equal. The port builds its engines
from its own copies of the sources, with ``ops/_build.py``'s g++ route, into
``reth_tpu_torch/build/``: a failed build raises ``BuildError`` and no case
skips. The reference's SIGKILL child and its sanitizer stress run on the
port's sources. A seeded random sequence of puts, duplicate puts, deletes,
clears and aborts goes through both packages' ``NativeDb`` and ``PagedDb``,
each in a child process: the walks are equal, each package opens the other's
store and walks it the same, and the engines' files are byte-identical
(neither engine writes anything that varies from run to run: ``pagedkv.cpp``'s
transaction ids count commits). One sequence makes the reference's paged
engine abort after a delete of an absent key, a fault the port's copy
repairs: ``test_paged_engine_survives_deleting_an_absent_key`` and
``test_paged_engine_survives_deleting_an_absent_value`` show it on its own.
"""

from __future__ import annotations

import hashlib
import inspect
import itertools
import os
import pickle
import random
import re
import shutil
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from _torch_storage_pkgs import PORT, REF, Account, ChainBuilder, Wallet, both, init_genesis
from reth_tpu.primitives.keccak import keccak256_batch_np

REPO = Path(__file__).resolve().parent.parent
PORT_CSRC = REPO / "reth_tpu_torch" / "csrc"


def sha(i: int) -> bytes:
    return hashlib.sha256(str(i).encode()).digest()


def _make(P, backend: str, d: Path):
    if backend == "mem":
        return P.MemDb()
    if backend == "paged":
        return P.native.PagedDb(d / "paged")
    return P.native.NativeDb(d / "native")


def _files(path: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir()) if p.is_file()}


def test_engines_build_from_the_ports_own_sources(tmp_path):
    """The port's copies are the reference's sources, ``pagedkv.cpp`` apart
    from how it maps its data file (a PROT_NONE reservation with the file
    mapped over its front as it grows, ``env_map_to``; the file format is
    the same) and from the absent-key delete's repair (``del_finds`` and the
    two lines of ``table_del`` that call it), and each engine loads from a
    library g++ built from them into the port's build directory."""
    import difflib

    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.storage import native

    for src in ("kvstore.cpp", "kvstore_tsan.cpp"):
        assert (PORT_CSRC / src).read_bytes() == (REPO / "native" / src).read_bytes()
    ref = (REPO / "native" / "pagedkv.cpp").read_text().splitlines()
    port_text = (PORT_CSRC / "pagedkv.cpp").read_text()
    repair = re.search(r"\n// Whether a delete finds what it removes.*?\n}\n", port_text, re.S)
    assert repair and "bool del_finds(" in repair[0]
    port = (port_text[:repair.start()] + port_text[repair.end():]).splitlines()
    changed = [line[1:] for line in difflib.unified_diff(ref, port, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    mapping = re.compile(r"^\s*(//|$)|map|MAP|fstat|PROT_|-1, 0\)|return true;|^\s*}$|^}$|"
                         r"if \(p == |uint64_t want|if \(want")
    table_del = re.compile(r"del_finds\(t, ti->root, key, val\)|"
                           r"tree_descend\(t, &ti->root, key, path, (true|ti->root != 0), &exact\)|"
                           r"^\s*return false;$")
    assert changed and all(mapping.search(line) or table_del.search(line)
                           for line in changed), changed
    assert sum("del_finds(" in line for line in changed) == 1
    native.NativeDb().close()
    native.PagedDb(tmp_path / "probe").close()
    built = _build.loaded_from()
    for src in ("kvstore.cpp", "pagedkv.cpp"):
        lib = built[PORT_CSRC / src]
        assert lib.parent == _build.BUILD_DIR and lib.name.startswith(f"lib{src[:-4]}-")


@pytest.mark.parametrize("engine", ["kvstore", "pagedkv"])
def test_failed_build_raises(tmp_path, monkeypatch, engine):
    """A source that does not compile raises ``BuildError`` out of the
    engine's constructor; nothing falls back or skips."""
    from reth_tpu_torch.ops import _build
    from reth_tpu_torch.storage import native

    src = tmp_path / "csrc"
    src.mkdir()
    (src / f"{engine}.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC_DIR", src)
    monkeypatch.setattr(native, "_apis", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    cls = native.PagedDb if engine == "pagedkv" else native.NativeDb
    with pytest.raises(_build.BuildError, match=f"building {engine}.cpp failed"):
        cls(tmp_path / "db")


# -- tests/test_native_kv.py --------------------------------------------------


def _wal_roundtrip(P, d):
    db = P.native.NativeDb(d / "kv")
    with db.tx_mut() as tx:
        tx.put("t", b"k1", b"v1")
        tx.put("d", b"k", b"b", dupsort=True)
        tx.put("d", b"k", b"a", dupsort=True)
    with db.tx_mut() as tx:
        tx.put("t", b"k2", b"v2")
        tx.delete("d", b"k", b"b")
    db.close()
    db2 = P.native.NativeDb(d / "kv")
    got = (db2.tx().get("t", b"k1"), db2.tx().get("t", b"k2"), db2.tx().get_dups("d", b"k"))
    db2.close()
    assert got == (b"v1", b"v2", [b"a"])
    return got, _files(d / "kv")


def test_wal_persistence_roundtrip(tmp_path):
    both(_wal_roundtrip, tmp_path)


def _uncommitted(P, d):
    db = P.native.NativeDb(d / "kv")
    with db.tx_mut() as tx:
        tx.put("t", b"committed", b"1")
    tx = db.tx_mut()
    tx.put("t", b"aborted", b"2")
    tx.abort()
    db.close()
    db2 = P.native.NativeDb(d / "kv")
    got = db2.tx().get("t", b"committed"), db2.tx().get("t", b"aborted")
    db2.close()
    assert got == (b"1", None)
    return got, _files(d / "kv")


def test_uncommitted_wal_tail_dropped(tmp_path):
    both(_uncommitted, tmp_path)


def _compaction(P, d):
    db = P.native.NativeDb(d / "kv")
    for i in range(50):
        with db.tx_mut() as tx:
            tx.put("t", bytes([i]), bytes([i]) * 3)
    db.flush()  # snapshot + truncate WAL
    with db.tx_mut() as tx:
        tx.put("t", b"\xff", b"post-snapshot")
    db.close()
    db2 = P.native.NativeDb(d / "kv")
    got = (db2.tx().get("t", b"\x07"), db2.tx().get("t", b"\xff"), db2.tx().entry_count("t"))
    db2.close()
    assert got == (b"\x07" * 3, b"post-snapshot", 51)
    return got, _files(d / "kv")


def test_snapshot_compaction(tmp_path):
    both(_compaction, tmp_path)


@pytest.fixture(scope="module")
def chain3():
    from reth_tpu.trie import TrieCommitter

    alice = Wallet(0xA11CE)
    builder = ChainBuilder({alice.address: Account(balance=10**21)},
                           committer=TrieCommitter(hasher=keccak256_batch_np))
    for i in range(3):
        builder.build_block([alice.transfer(b"\x0b" * 20, 100 + i)])
    return builder


def _pipeline_e2e(P, d, builder, engine):
    factory = P.ProviderFactory(getattr(P.native, engine)(d / "node"))
    init_genesis(P, factory, builder)
    P.import_chain(factory, [P.block(b) for b in builder.blocks[1:]], P.consensus())
    P.Pipeline(factory, P.stages()).run(3)
    p = factory.provider()
    assert p.stage_checkpoint("Finish") == 3
    assert p.header_by_number(3).state_root == builder.blocks[3].header.state_root
    assert p.account(b"\x0b" * 20).balance == 303
    walk = {t: list(p.tx.cursor(t).walk()) for t in ("HashedAccounts", "AccountsTrie",
                                                     "PlainAccountState", "StageCheckpoints")}
    return walk


@pytest.mark.parametrize("engine", ["NativeDb", "PagedDb"])
def test_pipeline_e2e_on_native_backends(tmp_path, chain3, engine):
    """The full staged sync runs unchanged over either C++ engine, and its
    tables walk the same in both packages."""
    both(_pipeline_e2e, tmp_path, chain3, engine)


# -- tests/test_paged_kv.py ---------------------------------------------------


def _reopen_multi(P, d):
    db = P.native.PagedDb(d / "kv")
    for batch in range(5):
        with db.tx_mut() as tx:
            for i in range(200):
                tx.put("t", sha(batch * 200 + i), b"v%d" % (batch * 200 + i))
    db.close()
    db2 = P.native.PagedDb(d / "kv")
    with db2.tx() as tx:
        assert tx.entry_count("t") == 1000
        assert tx.get("t", sha(777)) == b"v777"
        keys = [k for k, _ in tx.cursor("t").walk()]
        assert keys == sorted(keys) and len(keys) == 1000
    db2.close()
    return keys, _files(d / "kv")


def test_reopen_multi_commit(tmp_path):
    both(_reopen_multi, tmp_path)


def _dup_spill(P, d):
    rng = random.Random(11)
    db = P.native.PagedDb(d / "kv")
    vals = sorted(rng.randbytes(40) for _ in range(500))
    with db.tx_mut() as tx:
        for v in reversed(vals):
            tx.put("d", b"hot-key", v, dupsort=True)
        tx.put("d", b"cold", b"single", dupsort=True)
    with db.tx() as tx:
        assert tx.entry_count("d") == 501
        assert tx.get_dups("d", b"hot-key") == vals
        cur = tx.cursor("d")
        assert cur.seek_by_key_subkey(b"hot-key", vals[250]) == (b"hot-key", vals[250])
        assert cur.next_dup() == (b"hot-key", vals[251])
        assert cur.seek(b"hot-key") == (b"hot-key", vals[0])
    with db.tx_mut() as tx:
        for v in vals[:499]:
            assert tx.delete("d", b"hot-key", v)
    with db.tx() as tx:
        assert tx.get_dups("d", b"hot-key") == [vals[499]]
        assert tx.entry_count("d") == 2
        walk = list(tx.cursor("d").walk())
    db.close()
    return walk, _files(d / "kv")


def test_dup_subtree_spill_and_unspill(tmp_path):
    both(_dup_spill, tmp_path)


def _overflow(P, d):
    rng = random.Random(12)
    big1, big2 = rng.randbytes(30_000), rng.randbytes(70_000)
    db = P.native.PagedDb(d / "kv")
    with db.tx_mut() as tx:
        tx.put("t", b"blob", big1)
    with db.tx_mut() as tx:
        tx.put("t", b"blob", big2)  # replaces: frees the old chain
    with db.tx() as tx:
        assert tx.get("t", b"blob") == big2
    db.close()
    db2 = P.native.PagedDb(d / "kv")
    assert db2.tx().get("t", b"blob") == big2
    db2.close()
    return _files(d / "kv")


def test_overflow_values_roundtrip_and_replace(tmp_path):
    both(_overflow, tmp_path)


def _churn(P, d):
    rng = random.Random(13)
    db = P.native.PagedDb(d / "kv")
    with db.tx_mut() as tx:
        for i in range(2000):
            tx.put("t", sha(i), rng.randbytes(64))
    size_after_load = (d / "kv" / "data.rtpg").stat().st_size
    for _round in range(30):
        with db.tx_mut() as tx:
            for i in range(0, 2000, 10):
                tx.put("t", sha(i), rng.randbytes(64))
    size_after_churn = (d / "kv" / "data.rtpg").stat().st_size
    db.close()
    assert size_after_churn < size_after_load * 3, (size_after_load, size_after_churn)
    return size_after_load, size_after_churn


def test_space_reuse_under_churn(tmp_path):
    both(_churn, tmp_path)


_KILL_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from reth_tpu_torch.storage.native import PagedDb
    db = PagedDb({path!r})
    i = 0
    while True:
        with db.tx_mut() as tx:
            # each commit writes a consistent (count, payload) pair
            tx.put("t", b"count", str(i).encode())
            tx.put("t", b"k%06d" % i, b"x" * 100)
        i += 1
        print(i, flush=True)
""")


def test_crash_recovery_kill9(tmp_path):
    """SIGKILL a child that imports only ``reth_tpu_torch`` mid commit stream:
    the port reopens a consistent recent state (the dual-meta flip, no WAL
    replay), and the reference opens the same bytes to the same state."""
    d = tmp_path / "kv"
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD.format(repo=str(REPO), path=str(d))],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    seen = 0
    for line in proc.stdout:
        seen = int(line)
        if seen >= 300:
            os.kill(proc.pid, signal.SIGKILL)
            break
    proc.wait(timeout=30)
    assert seen >= 300
    states = []
    for P in (PORT, REF):
        copy = tmp_path / f"copy-{P.name}"
        shutil.copytree(d, copy)
        db = P.native.PagedDb(copy)
        with db.tx() as tx:
            count = int(tx.get("t", b"count"))
            assert count >= seen - 2
            for i in (0, count // 2, count):
                assert tx.get("t", b"k%06d" % i) == b"x" * 100, i
            states.append(list(tx.cursor("t").walk()))
        db.close()
    assert states[0] == states[1]


def _clear_recreate(P, d):
    db = P.native.PagedDb(d / "kv")
    with db.tx_mut() as tx:
        for i in range(500):
            tx.put("t", sha(i), b"v")
        tx.put("d", b"k", b"a", dupsort=True)
        tx.put("d", b"k", b"b", dupsort=True)
    with db.tx_mut() as tx:
        tx.clear("t")
        tx.clear("d")
    with db.tx() as tx:
        assert tx.entry_count("t") == 0
        assert tx.cursor("t").first() is None
        assert tx.get_dups("d", b"k") == []
    with db.tx_mut() as tx:
        tx.put("t", b"fresh", b"start")
    assert db.tx().get("t", b"fresh") == b"start"
    db.close()
    return _files(d / "kv")


def test_clear_and_recreate_table(tmp_path):
    both(_clear_recreate, tmp_path)


def _own_writes(P, d):
    db = P.native.PagedDb(d / "kv")
    with db.tx_mut() as tx:
        tx.put("t", b"a", b"1")
        tx.put("t", b"c", b"3")
    tx = db.tx_mut()
    cur = tx.cursor("t")
    seen = [cur.first()]
    tx.put("t", b"b", b"2")
    seen.append(cur.next())
    tx.delete("t", b"c")
    seen.append(cur.next())
    tx.abort()
    db.close()
    assert seen == [(b"a", b"1"), (b"b", b"2"), None]
    return seen


def test_write_txn_sees_own_writes_via_cursor(tmp_path):
    both(_own_writes, tmp_path)


# -- tests/test_mvcc.py -------------------------------------------------------

BATCHES = 60
KEYS = 40


def _writer(db, stop):
    for i in range(1, BATCHES + 1):
        with db.tx_mut() as tx:
            total = 0
            for k in range(KEYS):
                v = i * 1000 + k
                total += v
                tx.put("t", b"k%03d" % k, v.to_bytes(8, "big"))
            tx.put("t", b"sum", total.to_bytes(8, "big"))
    stop.set()


def _reader(db, stop, errors):
    while True:
        tx = db.tx()
        try:
            s = tx.get("t", b"sum")
            if s is not None:
                declared = int.from_bytes(s, "big")
                got = n = 0
                for k, v in tx.cursor("t").walk():
                    if k.startswith(b"k"):
                        got += int.from_bytes(v, "big")
                        n += 1
                if n != KEYS or got != declared:
                    errors.append(f"inconsistent snapshot: n={n} got={got} declared={declared}")
                    return
        finally:
            tx.abort()
        if stop.is_set():
            return


@pytest.mark.parametrize("backend", ["mem", "native", "paged"])
def test_concurrent_reader_writer_snapshots(tmp_path, backend):
    db = _make(PORT, backend, tmp_path)
    stop = threading.Event()
    errors: list[str] = []
    readers = [threading.Thread(target=_reader, args=(db, stop, errors)) for _ in range(3)]
    w = threading.Thread(target=_writer, args=(db, stop))
    for t in readers:
        t.start()
    w.start()
    w.join(timeout=120)
    for t in readers:
        t.join(timeout=30)
        assert not t.is_alive(), "reader thread wedged"
    assert not errors, errors[:3]
    with db.tx() as tx:
        assert int.from_bytes(tx.get("t", b"k000"), "big") == BATCHES * 1000


def _snapshot_stable(P, d, backend):
    db = _make(P, backend, d)
    with db.tx_mut() as tx:
        tx.put("t", b"a", b"1")
    reader = db.tx()
    assert reader.get("t", b"a") == b"1"
    with db.tx_mut() as tx:
        tx.put("t", b"a", b"2")
        tx.put("t", b"b", b"3")
        tx.clear("u")
    seen = [reader.get("t", b"a"), reader.get("t", b"b"),
            [k for k, _ in reader.cursor("t").walk()]]
    reader.abort()
    fresh = db.tx()
    seen += [fresh.get("t", b"a"), fresh.get("t", b"b")]
    fresh.abort()
    assert seen == [b"1", None, [b"a"], b"2", b"3"]
    return seen


@pytest.mark.parametrize("backend", ["mem", "native", "paged"])
def test_reader_snapshot_stable_across_commit(tmp_path, backend):
    both(_snapshot_stable, tmp_path, backend)


def _abort_discards(P, d, backend):
    db = _make(P, backend, d)
    with db.tx_mut() as tx:
        tx.put("t", b"x", b"keep")
    tx = db.tx_mut()
    tx.put("t", b"x", b"changed")
    tx.put("t", b"y", b"new")
    tx.clear("t")
    tx.put("t", b"z", b"after-clear")
    tx.abort()
    check = db.tx()
    seen = [check.get("t", b"x"), check.get("t", b"y"), check.get("t", b"z")]
    check.abort()
    assert seen == [b"keep", None, None]
    return seen


@pytest.mark.parametrize("backend", ["mem", "native", "paged"])
def test_abort_discards_all_writes(tmp_path, backend):
    both(_abort_discards, tmp_path, backend)


# -- tests/test_storage.py, the backend-parametrised contract -----------------


def _db_maker(P, backend, d):
    if backend == "mem":
        return P.MemDb
    seq = itertools.count()
    if backend == "paged":
        return lambda: P.native.PagedDb(d / f"paged{next(seq)}")
    return P.native.NativeDb


def _kv_basic(P, d, backend):
    db = _db_maker(P, backend, d)()
    with db.tx_mut() as tx:
        for k in (b"b", b"a", b"c"):
            tx.put("t", k, b"v" + k)
    cur = db.tx().cursor("t")
    seen = [[k for k, _ in cur.walk()], cur.seek(b"aa"), cur.seek_exact(b"aa"),
            cur.seek_exact(b"c"), cur.prev(), cur.last()]
    assert seen == [[b"a", b"b", b"c"], (b"b", b"vb"), None, (b"c", b"vc"),
                    (b"b", b"vb"), (b"c", b"vc")]
    return seen


def _dupsort(P, d, backend):
    db = _db_maker(P, backend, d)()
    with db.tx_mut() as tx:
        tx.put("d", b"k1", b"bbb", dupsort=True)
        tx.put("d", b"k1", b"aaa", dupsort=True)
        tx.put("d", b"k1", b"ccc", dupsort=True)
        tx.put("d", b"k2", b"zzz", dupsort=True)
    cur = db.tx().cursor("d")
    seen = [list(cur.walk_dup(b"k1")), cur.seek_by_key_subkey(b"k1", b"bb"),
            cur.seek_by_key_subkey(b"k1", b"zzz"), [v for _, v in db.tx().cursor("d").walk()]]
    if P is PORT:  # the port's subkey lookup lands where the cursor does
        assert [db.tx().seek_dup("d", b"k1", s) for s in (b"", b"bb", b"zzz")] == \
            [b"aaa", b"bbb", None]
    with db.tx_mut() as tx:
        assert tx.delete("d", b"k1", b"bbb")
    seen.append(list(db.tx().cursor("d").walk_dup(b"k1")))
    assert seen[:4] == [[(b"k1", b"aaa"), (b"k1", b"bbb"), (b"k1", b"ccc")],
                        (b"k1", b"bbb"), None, [b"aaa", b"bbb", b"ccc", b"zzz"]]
    assert seen[-1] == [(b"k1", b"aaa"), (b"k1", b"ccc")]
    return seen


def _failed_seek(P, d, backend):
    db = _db_maker(P, backend, d)()
    with db.tx_mut() as tx:
        for k in (b"a", b"b", b"c"):
            tx.put("t", k, b"v" + k)
    cur = db.tx().cursor("t")
    seen = [cur.seek(b"zzz"), cur.next(), cur.prev()]
    cur2 = db.tx().cursor("t")
    seen += [cur2.seek_exact(b"nope"), cur2.next(), db.tx().cursor("t").next()]
    assert seen == [None, None, (b"c", b"vc"), None, None, (b"a", b"va")]
    return seen


def _abort(P, d, backend):
    db = _db_maker(P, backend, d)()
    with db.tx_mut() as tx:
        tx.put("t", b"k", b"v1")
    tx = db.tx_mut()
    tx.put("t", b"k", b"v2")
    tx.put("t", b"k2", b"x")
    tx.delete("t", b"k")
    tx.clear("t")
    tx.put("t", b"k3", b"z")
    tx.abort()
    seen = [db.tx().get("t", b"k"), db.tx().get("t", b"k2"), db.tx().get("t", b"k3")]
    assert seen == [b"v1", None, None]
    return seen


def _provider(P, d, backend):
    factory = P.ProviderFactory(_db_maker(P, backend, d)())
    A = P.types.Account
    addr = b"\x0a" * 20
    with factory.provider_rw() as p:
        p.put_account(addr, A(nonce=1, balance=100))
        p.put_storage(addr, b"\x01" * 32, 42)
        p.put_storage(addr, b"\x01" * 32, 43)  # overwrite
        p.record_account_change(5, addr, None)
    p = factory.provider()
    acc = p.account(addr)
    assert acc == A(nonce=1, balance=100)
    assert p.account_storage(addr) == {b"\x01" * 32: 43}
    assert p.account_changes_in_range(5, 5) == {addr: None}
    return (acc.nonce, acc.balance), p.account_storage(addr)


@pytest.mark.parametrize("backend", ["mem", "native", "paged"])
@pytest.mark.parametrize("case", [_kv_basic, _dupsort, _failed_seek, _abort, _provider],
                         ids=["kv_basic_and_cursor_order", "dupsort", "cursor_failed_seek",
                              "abort", "provider"])
def test_backend_contract(tmp_path, case, backend):
    both(case, tmp_path, backend)


# -- tests/test_fuzz.py: the sanitized MVCC stress ----------------------------


def _probe_tsan(tmp: Path) -> bool:
    """gcc-12's libtsan SEGVs on 6.18+ kernels; probe before trusting it."""
    probe = tmp / "probe.cpp"
    probe.write_text("#include <thread>\nint main(){std::thread t([]{});"
                     "t.join();return 0;}\n")
    exe = tmp / "probe"
    r = subprocess.run(["g++", "-std=c++17", "-fsanitize=thread", str(probe), "-o", str(exe)],
                       capture_output=True)
    if r.returncode != 0:
        return False
    r = subprocess.run([str(exe)], capture_output=True, timeout=60)
    return r.returncode == 0


def test_sanitized_concurrent_stress(tmp_path):
    """The port's MVCC engine (``csrc/kvstore.cpp``) under a sanitizer with
    the torn-snapshot detector (``csrc/kvstore_tsan.cpp``): TSAN where its
    runtime works on this kernel, ASan+UBSan otherwise."""
    san = "thread" if _probe_tsan(tmp_path) else "address,undefined"
    exe = tmp_path / "kvstore_stress"
    r = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-g", f"-fsanitize={san}",
         str(PORT_CSRC / "kvstore.cpp"), str(PORT_CSRC / "kvstore_tsan.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    env = {"TSAN_OPTIONS": "halt_on_error=1", "ASAN_OPTIONS": "halt_on_error=1",
           "PATH": "/usr/bin:/bin"}
    r = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert "STRESS_OK" in r.stdout


# -- a seeded random sequence on both packages' stores ------------------------


def _ops(seed: int, n_txs: int = 40):
    """Transactions of puts, duplicate puts, deletes (of a key, present or
    not, or of one duplicate) and clears; every fifth is aborted."""
    rng = random.Random(seed)
    keys = [rng.randbytes(rng.choice((1, 8, 20, 32))) for _ in range(60)]
    txs = []
    for i in range(n_txs):
        ops = []
        for _ in range(rng.randint(1, 25)):
            r = rng.random()
            table = rng.choice(("t", "u"))
            k = rng.choice(keys)
            if r < 0.45:
                ops.append(("put", table, k, rng.randbytes(rng.randint(0, 300))))
            elif r < 0.75:
                ops.append(("dup", "d", k, rng.randbytes(rng.randint(1, 40))))
            elif r < 0.9:
                ops.append(("del", table, k, None))
            elif r < 0.97:
                ops.append(("deldup", "d", k, None))
            else:
                ops.append(("clear", table, None, None))
        txs.append((ops, i % 5 == 4))
    return txs


def _walk(db) -> dict:
    with db.tx() as tx:
        return {t: list(tx.cursor(t).walk()) for t in ("t", "u", "d")}


def _apply(db, txs, flush_every: int = 0, progress=None, absent=None) -> None:
    """Run ``txs`` on ``db``; ``absent``, a list, collects the (transaction,
    operation) positions of the deletes of a key or a value that is not
    there."""
    for i, (ops, aborted) in enumerate(txs):
        if progress is not None:
            progress(i)
        tx = db.tx_mut()
        for j, (op, table, k, v) in enumerate(ops):
            if absent is not None and op in ("del", "delval") and (
                    tx.get(table, k) is None if op == "del" else v not in tx.get_dups(table, k)):
                absent.append((i, j))
            if op == "put":
                tx.put(table, k, v)
            elif op == "dup":
                tx.put(table, k, v, dupsort=True)
            elif op == "del":
                tx.delete(table, k)
            elif op == "delval":
                tx.delete(table, k, v)
            elif op == "deldup":
                dups = tx.get_dups(table, k)
                if dups:
                    tx.delete(table, k, dups[len(dups) // 2])
            else:
                tx.clear(table)
        tx.abort() if aborted else tx.commit()
        if flush_every and i % flush_every == flush_every - 1:
            db.flush()


# the write sequences run in a child per package and engine: the reference's
# paged engine can abort the process after a delete of an absent key
_SEQUENCE_CHILD = textwrap.dedent("""
    import importlib, pickle, sys
    repo, pkg, spec = sys.argv[1:]
    sys.path.insert(0, repo)
    native = importlib.import_module(pkg + ".storage.native")
    txs, engine, path, flush_every, out = pickle.loads(open(spec, "rb").read())
""") + inspect.getsource(_walk) + inspect.getsource(_apply) + textwrap.dedent("""
    db = getattr(native, engine)(path)
    _apply(db, txs, flush_every, progress=lambda i: print(i, flush=True))
    pickle.dump(_walk(db), open(out, "wb"))
    db.close()
""")


def _run_sequence(tmp: Path, pkg: str, engine: str, txs, path: Path, flush_every: int = 0):
    """``(outcome, walks)``: the child's exit code, the last transaction it
    began and the tail of its errors, and the tables it walked at the end."""
    spec, out = tmp / f"{pkg}-{engine}-{path.name}.spec", tmp / f"{pkg}-{engine}-{path.name}.out"
    spec.write_bytes(pickle.dumps((txs, engine, str(path), flush_every, str(out))))
    r = subprocess.run([sys.executable, "-c", _SEQUENCE_CHILD, str(REPO), pkg, str(spec)],
                       capture_output=True, text=True, timeout=300)
    last = r.stdout.split()[-1] if r.stdout.split() else None
    err = r.stderr.strip().splitlines()[-1:] if r.returncode else []
    # the abort's message without the source's directory and line
    err = [re.sub(r"\S*pagedkv\.cpp:\d+:", "pagedkv.cpp:", e) for e in err]
    walks = pickle.loads(out.read_bytes()) if r.returncode == 0 else None
    return (r.returncode, last, err), walks


@pytest.mark.parametrize("engine", ["NativeDb", "PagedDb"])
@pytest.mark.parametrize("seed", [1, 2])
def test_random_sequence_walks_and_files_equal_across_packages(tmp_path, engine, seed):
    """Both packages' engines take the same sequence to the same end: the
    port's walks equal ``MemDb``'s and the reference's, and the files are
    byte-identical, each package's store walked the same by the other. The
    paged engines part where the sequence deletes an absent key: the port's
    repaired copy goes on, the reference's can abort (seed 2, ROADMAP C
    departures), and the files, which the reference's copied root then
    changes, are compared only where neither package took that path: on the
    same sequence less its absent-key deletes."""
    txs = _ops(seed)
    flush = 7 if engine == "NativeDb" else 0
    runs = {pkg: _run_sequence(tmp_path, pkg, engine, txs, tmp_path / pkg, flush)
            for pkg in ("reth_tpu", "reth_tpu_torch")}
    outcome, walks = runs["reth_tpu_torch"]
    assert outcome == (0, str(len(txs) - 1), [])
    mem, absent = PORT.MemDb(), []
    _apply(mem, txs, absent=absent)
    assert _walk(mem) == walks
    ref_outcome, ref_walks = runs["reth_tpu"]
    diverged = engine == "PagedDb" and bool(absent)
    if engine == "PagedDb" and seed == 2:
        assert diverged and ref_outcome[0] == -signal.SIGABRT
    if ref_outcome[0] != 0:
        assert diverged and "tx_writable" in ref_outcome[2][0]
    else:
        assert ref_walks == walks
    if diverged:
        txs, tmp_path = _without(txs, absent), tmp_path / "kept"
        tmp_path.mkdir()
        runs = {pkg: _run_sequence(tmp_path, pkg, engine, txs, tmp_path / pkg)
                for pkg in ("reth_tpu", "reth_tpu_torch")}
        walks = runs["reth_tpu_torch"][1]
        mem = PORT.MemDb()
        _apply(mem, txs)
        for outcome, got in runs.values():
            assert outcome == (0, str(len(txs) - 1), []) and got == _walk(mem)
    assert _files(tmp_path / "reth_tpu_torch") == _files(tmp_path / "reth_tpu")
    for reader, writer in ((PORT, "reth_tpu"), (REF, "reth_tpu_torch")):
        db = getattr(reader.native, engine)(tmp_path / writer)
        assert _walk(db) == walks
        db.close()


def _without(txs, absent) -> list:
    """``txs`` less the operations at the ``absent`` positions."""
    drop = set(absent)
    return [([o for j, o in enumerate(ops) if (i, j) not in drop], aborted)
            for i, (ops, aborted) in enumerate(txs)]


def test_paged_engine_survives_deleting_an_absent_key(tmp_path):
    """A committed transaction that deletes an absent key: the reference's
    ``pagedkv.cpp`` copies the table's root on write but leaves the catalog
    on the old root, which it frees; a later transaction reuses that page
    for another table, and the next write to the first table aborts the
    process (``tx_writable``'s assertion, transaction 3). The port's copy
    looks the key up before it descends for write (``del_finds``), so its
    ``PagedDb`` commits all four transactions and walks as ``MemDb`` does."""
    txs = [([("dup", "d", b"k1", b"x" * 32)], False),
           ([("put", "u", b"a", b"y" * 215)], False),
           ([("del", "u", b"absent", None)], False),
           ([("dup", "d", b"k2", b"z" * 7), ("put", "u", b"c", b"w" * 272)], False)]
    ref = _run_sequence(tmp_path, "reth_tpu", "PagedDb", txs, tmp_path / "reth_tpu")[0]
    assert ref[0] == -signal.SIGABRT and ref[1] == "3"
    assert "tx_writable" in ref[2][0]
    port, walks = _run_sequence(tmp_path, "reth_tpu_torch", "PagedDb", txs,
                                tmp_path / "reth_tpu_torch")
    assert port == (0, "3", [])
    mem = PORT.MemDb()
    _apply(mem, txs)
    assert _walk(mem) == walks
    # without the absent-key delete the reference commits the same writes
    ok = _run_sequence(tmp_path, "reth_tpu", "PagedDb", txs[:2] + txs[3:], tmp_path / "ok")
    assert ok[0] == (0, "2", [])


@pytest.mark.parametrize("dups", [3, 40], ids=["in-leaf", "sub-tree"])
def test_paged_engine_survives_deleting_an_absent_value(tmp_path, dups):
    """The same repair for a dup delete whose key is present and whose value
    is not: values kept in the leaf cell (3 of them) and values spilled to a
    sub-tree (40 of 32 bytes, past the cell's 512-byte spill). The port's
    ``PagedDb`` commits every transaction, later writes to both tables
    included, and walks as ``MemDb`` does; so does a present value's delete
    after it. The reference's copy aborts on the sub-tree case at the last
    transaction's write."""
    vals = [bytes([i]) * 32 for i in range(dups)]
    txs = [([("dup", "d", b"k1", v) for v in vals], False),
           ([("put", "u", b"a", b"y" * 215)], False),
           ([("delval", "d", b"k1", b"\xff" * 32)], False),
           ([("dup", "d", b"k2", b"z" * 7), ("put", "u", b"c", b"w" * 272),
             ("dup", "d", b"k1", b"\xfe" * 32)], False),
           ([("delval", "d", b"k1", vals[1]), ("put", "u", b"e", b"v" * 300)], False)]
    absent = []
    mem = PORT.MemDb()
    _apply(mem, txs, absent=absent)
    assert absent == [(2, 0)]
    port, walks = _run_sequence(tmp_path, "reth_tpu_torch", "PagedDb", txs, tmp_path / "port")
    assert port == (0, "4", [])
    assert _walk(mem) == walks
    assert len(walks["d"]) == dups + 1
    if dups > 3:  # the reference's sub-tree case aborts at the next write after it
        ref = _run_sequence(tmp_path, "reth_tpu", "PagedDb", txs, tmp_path / "ref")[0]
        assert ref[0] == -signal.SIGABRT and ref[1] == "4" and "tx_writable" in ref[2][0]
