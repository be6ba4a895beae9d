"""Write-ahead log + checkpoint manifest for the in-memory store.

A copy of the JAX package's ``storage/wal.py`` on the port's modules. Its
segments and manifest are the reference's byte for byte (records pickle only
builtin types), so a WAL written by either package replays in the other.
``DurabilityManager.attach_shipper`` / ``detach_shipper`` are plain hooks:
the fleet that ships records is not ported.

Reference analogue: the persistence thread + MDBX's durability contract
(crates/engine/tree/src/persistence.rs): reth survives ``kill -9``
because every committed transaction is on disk before the engine
considers it persisted. ``MemDb`` historically flushed its whole pickle
image only on graceful stop — a crash lost *every block since start*.
This module closes that hole without giving up the in-memory engine:

- **Durable commits** (:class:`WalStore`): every write transaction's
  delta (the clone-on-touch write set ``Tx._own`` already materializes)
  is appended to ``<datadir>/wal/<gen>.wal`` as a length-prefixed,
  CRC-checked, fsync'd record *before* the in-memory publish. A record
  is the unit of atomicity: replay applies whole records only and
  discards a torn (CRC-failing / truncated) tail, so a crash at any
  byte boundary recovers to the last complete commit.
- **Checkpoints**: periodically (every ``checkpoint_blocks`` persisted
  blocks, or when the segment outgrows ``RETH_TPU_WAL_SEGMENT_BYTES``)
  the pickle image is rewritten fsync-atomically, a fsync'd
  ``MANIFEST.json`` (generation, head hash/number, static-file jar
  digests) is swapped in, and segments older than the new generation
  are truncated away. Records carry absolute values (not diffs), so
  replaying a whole segment over a *newer* image is idempotent — every
  crash window between the checkpoint steps recovers cleanly.
- **Startup replay**: :meth:`WalStore.open` loads the manifest, replays
  every surviving segment in generation order into the freshly-opened
  ``MemDb``, discards the torn tail (counted + surfaced) and *truncates*
  it off the live segment so post-recovery appends continue a
  well-framed log, and attaches itself so subsequent commits append. A
  torn NON-final segment is mid-log corruption, not a crash tail: the
  corrupt segment and everything after it are quarantined aside
  (``*.wal.corrupt``), the surviving prefix is checkpointed immediately,
  and the loss is flagged (``lost_segments``) so startup recovery
  escalates to ``failed`` — durably committed records were dropped.

Record wire format (per segment, after the ``RTWL1\\n`` + u64-gen
header)::

    u32 payload_len | u32 crc32(payload) | payload
    payload = pickle({"seq": n, "tables": {table: delta}})
    delta   = {"replace": bool, "rows": {key: value}, "del": [keys]}

``RETH_TPU_FAULT_WAL_ACCEPT_TORN=1`` makes the reader accept a
CRC-failing record anyway — a *deliberately broken* recovery mode that
exists so the chaos invariant suite (chaos.py) can prove it catches a
recovery that silently applies corrupt data.
"""

from __future__ import annotations

import errno
import json
import os
import pickle
import struct
import threading
import time
import zlib
from pathlib import Path

from ..chaos import crash_point

SEGMENT_MAGIC = b"RTWL1\n"
MANIFEST_NAME = "MANIFEST.json"
# segment size ceiling forcing a checkpoint regardless of block cadence
DEFAULT_SEGMENT_BYTES = 16 * 1024 * 1024


# -- fsync plumbing (shared with kv.py / nippyjar.py) -------------------------


# errno values that mean "fsync is not supported here" (pipes, some
# special/virtual filesystems) — the only failures it is safe to ignore
_FSYNC_UNSUPPORTED = frozenset(
    e for e in (getattr(errno, name, None)
                for name in ("EINVAL", "ENOSYS", "ENOTSUP", "EOPNOTSUPP"))
    if e is not None)


def fsync_file(f) -> None:
    """flush + fsync an open file object.

    Only "fsync unsupported on this file" errno values are swallowed; a
    genuine EIO/ENOSPC must propagate to the committer — reporting a
    commit durable when its bytes never reached the platter is the
    classic fsync-gate failure mode.
    """
    f.flush()
    try:
        os.fsync(f.fileno())
    except OSError as e:  # pragma: no cover - platform-dependent
        if e.errno in _FSYNC_UNSUPPORTED:
            return
        raise


def fsync_dir(path: Path) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def write_json_atomic(path: Path, obj: dict) -> None:
    """tmp-write + fsync + rename + dir-fsync: the file either holds the
    old JSON or the new JSON, never a torn mix."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        fsync_file(f)
    tmp.replace(path)
    fsync_dir(path.parent)


# -- segment reader -----------------------------------------------------------


def _seg_name(gen: int) -> str:
    return f"{gen:08d}.wal"


def _seg_gen(path: Path) -> int:
    return int(path.stem)


def read_segment(path: Path):
    """Read one segment; returns ``(records, torn_bytes, accepted_torn)``.

    Stops at the first torn record: a truncated frame or a CRC mismatch
    (the crash window of an interrupted append). Everything after it is
    unreachable — framing is broken — so the tail is *discarded*, which
    is exactly the durability contract: a commit is recovered iff its
    record made it to disk whole.
    """
    accept_torn = os.environ.get("RETH_TPU_FAULT_WAL_ACCEPT_TORN", "") not in ("", "0")
    records: list[dict] = []
    accepted = 0
    data = path.read_bytes()
    if (not data.startswith(SEGMENT_MAGIC)
            or len(data) < len(SEGMENT_MAGIC) + 8):
        # unreadable/truncated header: the whole segment is torn
        return records, len(data), accepted
    (hdr_gen,) = struct.unpack_from("<Q", data, len(SEGMENT_MAGIC))
    try:
        name_gen = _seg_gen(path)
    except ValueError:
        name_gen = None
    if name_gen is not None and hdr_gen != name_gen:
        # a mis-renamed / cross-copied segment would replay under the
        # wrong generation order — treat the whole segment as torn
        return records, len(data), accepted
    pos = len(SEGMENT_MAGIC) + 8  # magic + u64 generation
    n = len(data)
    while pos < n:
        if n - pos < 8:
            break  # torn frame header
        length, crc = struct.unpack_from("<II", data, pos)
        if length > n - pos - 8:
            break  # torn payload
        payload = data[pos + 8:pos + 8 + length]
        if zlib.crc32(payload) != crc:
            if accept_torn:
                # deliberately broken mode (chaos negative drill): accept
                # the bit-rotted record so the invariant suite can prove
                # it notices the resulting corruption
                try:
                    records.append(pickle.loads(payload))
                    accepted += 1
                    pos += 8 + length
                    continue
                except Exception:  # noqa: BLE001 - unpicklable: still torn
                    pass
            break
        records.append(pickle.loads(payload))
        pos += 8 + length
    return records, n - pos, accepted


def _apply_delta(tables: dict, delta: dict, owned: set) -> None:
    """Apply one record's table deltas to a working table map.

    ``owned`` tracks tables already cloned this replay — published table
    dicts are immutable by MVCC contract, so each is cloned once before
    the first mutation.
    """
    for table, ops in delta.items():
        if ops.get("replace"):
            tables[table] = dict(ops.get("rows", {}))
            owned.add(table)
            continue
        t = tables.get(table)
        if table not in owned:
            t = dict(t) if t is not None else {}
            tables[table] = t
            owned.add(table)
        elif t is None:
            t = tables[table] = {}
        for k, v in ops.get("rows", {}).items():
            t[k] = list(v) if isinstance(v, list) else v
        for k in ops.get("del", ()):
            t.pop(k, None)


def jar_digest(path: Path) -> str | None:
    """Read a NippyJar's stored data sha256 from its header only (no
    mmap, no row decode) — cheap enough to stamp every jar into the
    checkpoint manifest."""
    from .nippyjar import LEGACY_MAGIC, MAGIC

    try:
        with open(path, "rb") as f:
            magic = f.read(6)
            if magic not in (MAGIC, LEGACY_MAGIC):
                return None
            (hlen,) = struct.unpack("<I", f.read(4))
            hdr = json.loads(f.read(hlen))
            return hdr.get("data_sha256")
    except Exception:  # noqa: BLE001 - a corrupt jar has no digest
        return None


# -- the store ----------------------------------------------------------------


class WalStore:
    """One WAL (directory of segments + manifest) beside one ``MemDb``."""

    def __init__(self, db, directory: str | Path):
        self.db = db
        self.dir = Path(directory)
        self._lock = threading.Lock()
        self._fh = None
        self.gen = 1
        self.seq = 0
        # counters surfaced via metrics.wal_metrics + the events line
        self.appends = 0
        self.bytes_appended = 0
        self.checkpoints = 0
        self.replayed_records = 0
        self.replay_torn_bytes = 0
        self.replay_accepted_torn = 0
        self.replay_segments = 0
        # mid-log corruption: segments quarantined aside because a torn
        # NON-final segment broke framing before them — their records
        # were durably committed and are now lost, so recovery escalates
        self.lost_segments: list[str] = []
        # fleet HA: monotonic leader epoch persisted in the manifest (a
        # promoted standby bumps it; a restarted old leader compares it
        # against the live feed's hello and fences itself if stale)
        self.epoch = 1
        # post-fsync shipping hooks (fleet/standby WAL replication):
        # observer(gen, seq, payload) runs under the append lock AFTER
        # the record is durable; manifest_observer(manifest) after each
        # checkpoint swap. Failures must never gate local durability.
        self.observer = None
        self.manifest_observer = None
        self.last_checkpoint_head: tuple[int, str] | None = None
        self._ckpt_number: int | None = None
        self.max_segment_bytes = int(
            os.environ.get("RETH_TPU_WAL_SEGMENT_BYTES", DEFAULT_SEGMENT_BYTES))
        try:
            from ..metrics import wal_metrics

            self._metrics = wal_metrics
        except Exception:  # noqa: BLE001 - metrics must never gate storage
            self._metrics = None

    # -- open / replay --------------------------------------------------------

    @classmethod
    def open(cls, db, directory: str | Path) -> "WalStore":
        """Open (creating if absent) the WAL for ``db``, replay surviving
        segments into it, and attach for subsequent commits."""
        store = cls(db, directory)
        store.dir.mkdir(parents=True, exist_ok=True)
        manifest = store.manifest()
        segs = sorted(store.dir.glob("*.wal"), key=_seg_gen)
        tables = dict(db._tables)
        owned: set = set()
        lost: list[Path] = []
        for i, seg in enumerate(segs):
            records, torn, accepted = read_segment(seg)
            for rec in records:
                _apply_delta(tables, rec.get("tables", {}), owned)
                store.seq = max(store.seq, rec.get("seq", 0))
            store.replayed_records += len(records)
            store.replay_accepted_torn += accepted
            if torn:
                store.replay_torn_bytes += torn
                if i + 1 < len(segs):
                    # mid-log corruption (not a crash tail): framing is
                    # broken in the MIDDLE of the durable history, so the
                    # later segments' records — real fsync'd commits —
                    # cannot be applied in order. Quarantine the corrupt
                    # segment and everything after it (they are unusable
                    # here anyway, but the bytes are kept for forensics)
                    # and checkpoint immediately below so the surviving
                    # prefix is durable; replay_report flags the loss so
                    # startup recovery escalates beyond "degraded".
                    lost = segs[i:]
                else:
                    # torn crash tail of the live segment: truncate the
                    # garbage so subsequent appends continue a
                    # well-framed log — without this, new records land
                    # AFTER unreadable bytes and the next replay stops
                    # at the tear, silently dropping every post-recovery
                    # commit until a checkpoint rotates the segment.
                    with open(seg, "rb+") as f:
                        f.truncate(seg.stat().st_size - torn)
                        fsync_file(f)
                break
        if owned:
            db._tables = tables
            db._dirty = True
        store.replay_segments = len(segs)
        gen = manifest["gen"] if manifest else 1
        if segs:
            gen = max(gen, _seg_gen(segs[-1]))
        if manifest:
            head = manifest.get("head_number")
            store._ckpt_number = head
            try:
                store.epoch = max(1, int(manifest.get("leader_epoch", 1)))
            except (TypeError, ValueError):
                store.epoch = 1
            if head is not None and manifest.get("head_hash"):
                store.last_checkpoint_head = (head, manifest["head_hash"])
        if lost:
            for seg in lost:
                dest = seg.with_suffix(seg.suffix + ".corrupt")
                k = 0
                while dest.exists():
                    k += 1
                    dest = seg.with_suffix(seg.suffix + f".corrupt-{k}")
                seg.replace(dest)
                store.lost_segments.append(dest.name)
            fsync_dir(store.dir)
            gen += 1  # never reuse a quarantined generation number
        store.gen = gen
        store._open_segment()
        db._wal = store
        if lost:
            # make the surviving prefix durable NOW: a crash before the
            # next cadence checkpoint must not lose the replayed records
            # whose segments were just quarantined
            store.checkpoint(head=store.last_checkpoint_head)
        return store

    def manifest(self) -> dict | None:
        path = self.dir / MANIFEST_NAME
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except Exception:  # noqa: BLE001 - corrupt manifest: quarantine
            k = 0
            while path.with_suffix(f".corrupt-{k}").exists():
                k += 1
            path.replace(path.with_suffix(f".corrupt-{k}"))
            return None

    def _open_segment(self) -> None:
        path = self.dir / _seg_name(self.gen)
        fresh = not path.exists() or path.stat().st_size == 0
        self._fh = open(path, "ab")
        if fresh:
            self._fh.write(SEGMENT_MAGIC + struct.pack("<Q", self.gen))
            fsync_file(self._fh)
            fsync_dir(self.dir)

    # -- append ---------------------------------------------------------------

    def append(self, delta: dict, publish=None) -> None:
        """fsync one commit record, then run ``publish`` under the same
        lock — a checkpoint can never snapshot state whose record it is
        about to truncate."""
        with self._lock:
            payload = pickle.dumps({"seq": self.seq + 1, "tables": delta},
                                   protocol=pickle.HIGHEST_PROTOCOL)
            frame = struct.pack("<II", len(payload), zlib.crc32(payload))
            path = self.dir / _seg_name(self.gen)
            # every append fsyncs, so on-disk size == pre-append offset
            start = path.stat().st_size
            try:
                self._fh.write(frame + payload)
                fsync_file(self._fh)
            except Exception:
                # ENOSPC/EIO mid-append: a half-written frame at the
                # tail would bury every later record behind a torn one —
                # rewind the segment to the pre-append offset (through a
                # fresh fd: the buffered writer may hold partial bytes)
                # so the log stays well-framed, then let the committer
                # see the failure
                try:
                    self._fh.close()
                except Exception:  # noqa: BLE001 - already broken fd
                    pass
                try:
                    os.truncate(path, start)
                except OSError:  # pragma: no cover - fs itself is gone
                    pass
                self._fh = open(path, "ab")
                raise
            self.seq += 1
            self.appends += 1
            self.bytes_appended += len(frame) + len(payload)
            if self._metrics is not None:
                self._metrics.record_append(len(frame) + len(payload),
                                            self._fh.tell())
            crash_point("wal-append")
            if self.observer is not None:
                try:
                    self.observer(self.gen, self.seq, payload)
                except Exception:  # noqa: BLE001 - shipping never gates
                    pass
            if publish is not None:
                publish()

    # -- checkpoint -----------------------------------------------------------

    def should_checkpoint(self, number: int, checkpoint_blocks: int) -> bool:
        if self._ckpt_number is None:
            return True
        if number - self._ckpt_number >= max(1, checkpoint_blocks):
            return True
        try:
            return (self.dir / _seg_name(self.gen)).stat().st_size \
                >= self.max_segment_bytes
        except OSError:
            return False

    def checkpoint(self, head: tuple[int, bytes] | None = None,
                   static_dir: str | Path | None = None) -> None:
        """Image + manifest swap + segment truncation.

        Step order is crash-safe end to end: (1) the next segment is
        created first, (2) the image is flushed fsync-atomically, (3)
        the manifest swaps generations, (4) old segments unlink. A crash
        between any two steps leaves replay-idempotent state — records
        carry absolute values, so replaying an old segment over a newer
        image converges to the same tables.
        """
        with self._lock:
            t0 = time.time()
            new_gen = self.gen + 1
            old_fh, self._fh = self._fh, None
            old_fh.close()
            self.gen = new_gen
            self._open_segment()
            self.db.flush()
            crash_point("checkpoint-swap")
            jars = {}
            if static_dir is not None and Path(static_dir).is_dir():
                for p in sorted(Path(static_dir).glob("*.sf")):
                    jars[p.name] = jar_digest(p)
            manifest = {"gen": new_gen, "written_at": time.time(),
                        "leader_epoch": self.epoch}
            if head is not None:
                manifest["head_number"] = head[0]
                manifest["head_hash"] = (head[1].hex()
                                         if isinstance(head[1], bytes)
                                         else head[1])
                self._ckpt_number = head[0]
                self.last_checkpoint_head = (manifest["head_number"],
                                             manifest["head_hash"])
            if jars:
                manifest["jars"] = jars
            write_json_atomic(self.dir / MANIFEST_NAME, manifest)
            for seg in sorted(self.dir.glob("*.wal"), key=_seg_gen):
                if _seg_gen(seg) < new_gen:
                    seg.unlink()
            fsync_dir(self.dir)
            self.checkpoints += 1
            self.last_checkpoint_s = time.time() - t0
            if self.manifest_observer is not None:
                try:
                    self.manifest_observer(dict(manifest))
                except Exception:  # noqa: BLE001 - shipping never gates
                    pass

    def snapshot_tables(self) -> tuple[dict, int, int]:
        """Consistent ``(tables, gen, seq)`` image under the append lock
        — the resync source for a fleet standby that detected a gap in
        the shipped record stream."""
        with self._lock:
            return ({k: dict(v) for k, v in self.db._tables.items()},
                    self.gen, self.seq)

    def segment_bytes(self) -> int:
        try:
            return (self.dir / _seg_name(self.gen)).stat().st_size
        except OSError:
            return 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if getattr(self.db, "_wal", None) is self:
                self.db._wal = None

    def snapshot(self) -> dict:
        return {
            "gen": self.gen, "seq": self.seq, "appends": self.appends,
            "bytes": self.bytes_appended, "checkpoints": self.checkpoints,
            "segment_bytes": self.segment_bytes(),
            "replayed": self.replayed_records,
            "torn_bytes": self.replay_torn_bytes,
            "lost_segments": len(self.lost_segments),
        }


# -- node-facing facade -------------------------------------------------------


class DurabilityManager:
    """The node's durability boundary: one or two :class:`WalStore`\\ s
    (two under storage-v2's split layout) + checkpoint cadence driven by
    ``EngineTree._advance_persistence`` — durability tracks the
    persistence threshold, not process lifetime."""

    def __init__(self, stores: list[WalStore], checkpoint_blocks: int = 8,
                 static_dir: str | Path | None = None):
        self.stores = stores
        self.checkpoint_blocks = max(1, int(checkpoint_blocks))
        self.static_dir = static_dir
        self._metrics_hook()

    def _metrics_hook(self):
        try:
            from ..metrics import wal_metrics

            wal_metrics.attach(self)
        except Exception:  # noqa: BLE001 - metrics must never gate storage
            pass

    @property
    def main(self) -> WalStore:
        return self.stores[0]

    # -- fleet HA shipping ----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.main.epoch

    def set_epoch(self, epoch: int) -> None:
        e = max(1, int(epoch))
        for store in self.stores:
            store.epoch = e

    def attach_shipper(self, on_record, on_manifest=None) -> None:
        """Route every durable append (and checkpoint manifest) to the
        fleet shipping hooks as ``(store_index, gen, seq, payload)`` /
        ``(store_index, manifest)`` — store_index disambiguates the
        split-layout aux WAL."""
        for i, store in enumerate(self.stores):
            store.observer = (lambda gen, seq, payload, _i=i:
                              on_record(_i, gen, seq, payload))
            if on_manifest is not None:
                store.manifest_observer = (lambda manifest, _i=i:
                                           on_manifest(_i, manifest))

    def detach_shipper(self) -> None:
        for store in self.stores:
            store.observer = None
            store.manifest_observer = None

    def snapshot_tables(self) -> list[tuple[dict, int, int]]:
        """Per-store consistent table images (resync payloads)."""
        return [store.snapshot_tables() for store in self.stores]

    def on_persisted(self, number: int, head_hash: bytes | None) -> None:
        """Called after every persistence advance (the durability
        boundary): commits are already fsync'd record-by-record; this
        only decides whether the log is due for truncation."""
        if self.main.should_checkpoint(number, self.checkpoint_blocks):
            self.checkpoint(head=(number, head_hash or b""))

    def checkpoint(self, head: tuple[int, bytes] | None = None) -> None:
        # aux first, main last — same order as SplitTx.commit, so a crash
        # in between leaves the aux image AHEAD, the direction
        # check_consistency() heals
        for store in reversed(self.stores[1:]):
            store.checkpoint()
        self.main.checkpoint(head=head, static_dir=self.static_dir)
        try:
            from ..metrics import wal_metrics

            wal_metrics.record_checkpoint(self)
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        for store in self.stores:
            store.close()

    def snapshot(self) -> dict:
        s = self.main.snapshot()
        for extra in self.stores[1:]:
            e = extra.snapshot()
            for k in ("appends", "bytes", "replayed", "torn_bytes",
                      "lost_segments"):
                s[k] += e[k]
        s["stores"] = len(self.stores)
        s["checkpoint_blocks"] = self.checkpoint_blocks
        return s

    def replay_report(self) -> dict:
        return {
            "records": sum(st.replayed_records for st in self.stores),
            "torn_bytes": sum(st.replay_torn_bytes for st in self.stores),
            "accepted_torn": sum(st.replay_accepted_torn
                                 for st in self.stores),
            "segments": sum(st.replay_segments for st in self.stores),
            "lost_segments": [f"{Path(st.dir).name}/{name}"
                              for st in self.stores
                              for name in st.lost_segments],
            "manifest_head": self.main.last_checkpoint_head,
        }


def attach_wal(db, wal_dir: str | Path, checkpoint_blocks: int = 8,
               static_dir: str | Path | None = None) -> DurabilityManager | None:
    """Attach a WAL to ``db`` (``MemDb`` — or a storage-v2 ``SplitDb``
    of MemDbs, one WAL per store). Replays surviving segments as a side
    effect. Returns None for backends with native durability (the C++
    WAL / paged engines)."""
    from .kv import MemDb
    from .settings import SplitDb

    wal_dir = Path(wal_dir)
    if isinstance(db, MemDb):
        return DurabilityManager([WalStore.open(db, wal_dir)],
                                 checkpoint_blocks, static_dir)
    if isinstance(db, SplitDb) and isinstance(db.main, MemDb) \
            and isinstance(db.aux, MemDb):
        return DurabilityManager(
            [WalStore.open(db.main, wal_dir),
             WalStore.open(db.aux, wal_dir.with_name(wal_dir.name + "-aux"))],
            checkpoint_blocks, static_dir)
    return None
