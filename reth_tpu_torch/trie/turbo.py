"""Turbo commit path: native structure sweep + array-level hashing backends.

Port of the JAX package's ``trie/turbo.py``. The full-rebuild pipeline has
no per-node Python:

  sorted 32-byte hashed keys + RLP values
    └─ csrc/triebuild.cpp  (C++ sweep: structure + RLP rows/masks, flat
       per-level arrays)
        └─ per level, deepest first, staged by MegaFusedEngine:
           PACKED rows  → dispatch_packed   (kernel 2)
           BITMAP rows  → dispatch_branch   (kernel 3)
           (SubtrieFusedEngine: k levels per launch of kernel 4)
           ... or the numpy twin (``_NumpyBackend``), which the caller picks
           explicitly with ``backend="numpy"``, or which ``backend="auto"``
           (``ops/supervisor.py SupervisedBackend``) fails over to
            └─ ONE digest read-back: roots (+ branch-node hashes when
               TrieUpdates collection is requested)
"""

from __future__ import annotations

import ctypes
import functools
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..device import resolve
from ..metrics import pipeline_metrics, trie_metrics
from ..ops import _build
from ..ops.fused_commit import (FusedMeshEngine, MegaFusedEngine, SubtrieFusedEngine,
                                SubtrieMeshEngine)
from ..ops.supervisor import DeviceSupervisor, FaultInjector, SupervisedBackend
from ..primitives.keccak import RATE, keccak256, keccak256_words_masked_np
from ..primitives.types import EMPTY_ROOT_HASH
from .committer import BranchNode, TrieBuildResult

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "triebuild.cpp"

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def load_library() -> ctypes.CDLL:
    """The native sweep, built with g++ into ``reth_tpu_torch/build/`` at
    first use (rebuilt when the source changes)."""
    lib = _build.load(_SRC)
    lib.rtb_build.restype = ctypes.c_void_p
    lib.rtb_build.argtypes = [_u8p, ctypes.c_uint64, _u64p, ctypes.c_uint32,
                              _u8p, _u64p, ctypes.c_int, ctypes.c_int, _i32p]
    lib.rtb_free.argtypes = [ctypes.c_void_p]
    for name, res in [("rtb_num_levels", ctypes.c_int32),
                      ("rtb_max_slot", ctypes.c_int32)]:
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.rtb_level_depth.restype = ctypes.c_uint32
    lib.rtb_level_depth.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.rtb_packed_bytes.restype = ctypes.c_uint64
    lib.rtb_packed_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ["rtb_packed_rows", "rtb_packed_holes", "rtb_bmp_rows",
                 "rtb_bmp_children"]:
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.rtb_packed_get.argtypes = [ctypes.c_void_p, ctypes.c_int32, _u8p, _u32p, _i32p]
    lib.rtb_packed_get_holes.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         _i32p, _i32p, _i32p]
    lib.rtb_bmp_get.argtypes = [ctypes.c_void_p, ctypes.c_int32, _u16p, _i32p]
    lib.rtb_bmp_get_children.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         _i32p, _i32p, _i32p]
    lib.rtb_roots.argtypes = [ctypes.c_void_p, _i32p]
    lib.rtb_root_inline_len.restype = ctypes.c_uint32
    lib.rtb_root_inline_len.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.rtb_root_inline.argtypes = [ctypes.c_void_p, ctypes.c_uint32, _u8p]
    lib.rtb_meta_count.restype = ctypes.c_uint64
    lib.rtb_meta_count.argtypes = [ctypes.c_void_p]
    lib.rtb_meta_get.argtypes = [ctypes.c_void_p, _u8p]
    return lib


def _ptr(arr: np.ndarray, ty):
    return arr.ctypes.data_as(ty)


class _Level:
    """One depth level as flat numpy arrays, straight from the native sweep."""

    __slots__ = ("depth", "flat", "row_off", "row_len", "row_slot", "holes",
                 "masks", "bmp_slot", "children", "b_tier")

    def __init__(self, lib, h, i):
        self.depth = lib.rtb_level_depth(h, i)
        nb = int(lib.rtb_packed_bytes(h, i))
        nr = int(lib.rtb_packed_rows(h, i))
        self.flat = np.zeros((nb,), dtype=np.uint8)
        row_off_full = np.zeros((nr + 1,), dtype=np.uint32)
        self.row_slot = np.zeros((nr,), dtype=np.int32)
        if nr:
            lib.rtb_packed_get(h, i, _ptr(self.flat, _u8p),
                               _ptr(row_off_full, _u32p), _ptr(self.row_slot, _i32p))
        self.row_off = row_off_full[:-1]
        self.row_len = np.diff(row_off_full).astype(np.uint32)
        nh = int(lib.rtb_packed_holes(h, i))
        if nh:
            self.holes = np.zeros((3, nh), dtype=np.int32)
            lib.rtb_packed_get_holes(h, i, _ptr(self.holes[0], _i32p),
                                     _ptr(self.holes[1], _i32p), _ptr(self.holes[2], _i32p))
        else:
            self.holes = None
        nbm = int(lib.rtb_bmp_rows(h, i))
        self.masks = np.zeros((nbm,), dtype=np.uint16)
        self.bmp_slot = np.zeros((nbm,), dtype=np.int32)
        nch = int(lib.rtb_bmp_children(h, i))
        self.children = np.zeros((3, max(nch, 0)), dtype=np.int32)
        if nbm:
            lib.rtb_bmp_get(h, i, _ptr(self.masks, _u16p), _ptr(self.bmp_slot, _i32p))
        if nch:
            lib.rtb_bmp_get_children(h, i, _ptr(self.children[0], _i32p),
                                     _ptr(self.children[1], _i32p),
                                     _ptr(self.children[2], _i32p))
        maxlen = int(self.row_len.max()) if nr else 0
        bt = 1
        while bt * RATE <= maxlen:
            bt *= 2
        self.b_tier = bt


class DigestArena:
    """Resident host staging for the numpy twin: the (S, 32) digest buffer
    grows geometrically and is reused across commits, and each hashing
    thread keeps a resident row-staging scratch. Growth preserves written
    digests, so a pipelined commit can extend it mid-flight."""

    def __init__(self):
        self._digests: np.ndarray | None = None
        self._tls = threading.local()

    def digest_buf(self, n_slots: int) -> np.ndarray:
        cur = self._digests
        if cur is None or cur.shape[0] < n_slots:
            cap = 1024 if cur is None else cur.shape[0]
            while cap < n_slots:
                cap *= 2
            buf = np.zeros((cap, 32), dtype=np.uint8)
            if cur is not None:
                buf[: cur.shape[0]] = cur
            self._digests = buf
        return self._digests

    def rows(self, n: int, length: int) -> np.ndarray:
        """Per-thread resident staging for one dispatch's padded rows."""
        need = n * length
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.size < need:
            buf = np.empty((max(need, 1 << 16),), dtype=np.uint8)
            self._tls.buf = buf
        return buf[:need].reshape(n, length)


class _NumpyBackend:
    """CPU twin of the device engine (the JAX package's ``_NumpyBackend``):
    the same array protocol as ``FusedLevelEngine``, with digests in a host
    buffer. It runs when the caller asks for ``backend="numpy"``, and under
    ``backend="auto"`` when the supervisor routes a commit to the CPU or
    fails it over; it touches no CUDA tensor."""

    effective_kind = "numpy"

    def __init__(self, arena: DigestArena | None = None):
        self._arena = arena
        self._buf = None
        self._n_slots = 1

    def begin(self, max_slots: int) -> None:
        if self._arena is not None:
            self._buf = self._arena.digest_buf(max_slots + 1)
        else:
            self._buf = np.zeros((max_slots + 1, 32), dtype=np.uint8)
        self._n_slots = 1  # slot 0 = dummy (mirrors FusedLevelEngine)

    def ensure(self, max_slots: int) -> None:
        need = max_slots + 1
        if self._buf is not None and self._buf.shape[0] >= need:
            return
        if self._arena is not None:
            self._buf = self._arena.digest_buf(need)
            return
        cap = max(1024, self._buf.shape[0] if self._buf is not None else 0)
        while cap < need:
            cap *= 2
        grown = np.zeros((cap, 32), dtype=np.uint8)
        if self._buf is not None:
            grown[: self._buf.shape[0]] = self._buf
        self._buf = grown

    def _rows_scratch(self, n: int, length: int) -> np.ndarray:
        if self._arena is not None:
            return self._arena.rows(n, length)
        return np.empty((n, length), dtype=np.uint8)

    def alloc_slot(self) -> int:
        slot = self._n_slots
        self._n_slots += 1
        return slot

    def dispatch_level(self, bucket) -> None:
        n = len(bucket.templates)
        if n == 0:
            return
        b_tier = 2
        while b_tier < bucket.nb_max:
            b_tier *= 2
        L = b_tier * RATE
        rows = self._rows_scratch(n, L)
        rows[:] = 0
        for i, t in enumerate(bucket.templates):
            rows[i, : len(t)] = np.frombuffer(t, dtype=np.uint8)
            rows[i, len(t)] ^= 0x01
            rows[i, bucket.counts[i] * RATE - 1] ^= 0x80
        for row, off, src in bucket.holes:
            rows[row, off : off + 32] = self._buf[src]
        self._hash_rows(rows, np.asarray(bucket.counts, dtype=np.int64),
                        np.asarray(bucket.slots, dtype=np.int64), b_tier)

    def _hash_rows(self, rows: np.ndarray, counts: np.ndarray, slots: np.ndarray,
                   b_tier: int) -> None:
        lanes = keccak256_words_masked_np(
            np.ascontiguousarray(rows).view("<u8"), b_tier, counts
        )
        self._buf[slots] = np.ascontiguousarray(lanes).view(np.uint8).reshape(-1, 32)

    def dispatch_packed(self, flat, row_off, row_len, slots, holes, b_tier) -> None:
        n = len(row_off)
        if n == 0:
            return
        L = b_tier * RATE
        col = np.arange(L, dtype=np.uint32)[None, :]
        idx = np.minimum(row_off[:, None] + col, max(len(flat) - 1, 0))
        rows = self._rows_scratch(n, L)
        if len(flat):
            np.take(flat, idx.astype(np.int64, copy=False), out=rows)
            np.multiply(rows, col < row_len[:, None], out=rows, casting="unsafe")
        else:
            rows[:] = 0
        r = np.arange(n)
        counts = (row_len // RATE + 1).astype(np.int64)
        rows[r, row_len] ^= 0x01
        rows[r, counts * RATE - 1] ^= 0x80
        if holes is not None:
            hr, ho, hs = holes
            rows[hr[:, None], ho[:, None] + np.arange(32)] = self._buf[hs]
        self._hash_rows(rows, counts, slots, b_tier)

    def dispatch_branch(self, masks, slots, children) -> None:
        n = len(masks)
        if n == 0:
            return
        L = 4 * RATE
        nibs = np.arange(16, dtype=np.int32)[None, :]
        present = ((masks[:, None].astype(np.int32) >> nibs) & 1).astype(np.int64)
        sizes = 1 + 32 * present
        csum = np.cumsum(sizes, axis=1) - sizes
        payload = sizes.sum(axis=1) + 1
        hl = np.where(payload > 0xFF, 3, 2)
        total = hl + payload
        rows = self._rows_scratch(n, L)
        rows[:] = 0
        rows[:, 0] = np.where(hl == 3, 0xF9, 0xF8)
        rows[:, 1] = np.where(hl == 3, payload >> 8, payload & 0xFF)
        rows[:, 2] = payload & 0xFF  # f8 rows: overwritten by first marker
        r16 = np.repeat(np.arange(n), 16)
        rows[r16, (hl[:, None] + csum).reshape(-1)] = np.where(
            present == 1, 0xA0, 0x80
        ).reshape(-1)
        rows[np.arange(n), total - 1] = 0x80
        cr, cn, cs = children
        off = hl[cr] + csum[cr, cn] + 1
        rows[cr[:, None], off[:, None] + np.arange(32)] = self._buf[cs]
        counts = total // RATE + 1
        rows[np.arange(n), total] ^= 0x01
        rows[np.arange(n), counts * RATE - 1] ^= 0x80
        self._hash_rows(rows, counts, slots, 4)

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        out = self._buf[slots]
        self._buf = None
        return out

    def finish(self) -> np.ndarray:
        buf, self._buf = self._buf, None
        return buf

    def flush_window(self) -> None:
        """Window-boundary hook; the twin hashes eagerly, so a no-op."""


def _marshal_and_build(lib, jobs, collect_branches: bool, start_depth: int):
    """Sort each job's keys, flatten values, and run the native structure
    sweep. Returns (handle, per-job sorted key arrays); the caller owns the
    handle (``rtb_free``). Raises ``ValueError`` on sweep rejection."""
    key_arrays, val_chunks, job_off = [], [], [0]
    for keys, values in jobs:
        keys = np.ascontiguousarray(keys, dtype=np.uint8).reshape(-1, 32)
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        order = np.argsort(keys.view("S32").ravel(), kind="stable")
        key_arrays.append(keys[order])
        val_chunks.extend(values[i] for i in order)
        job_off.append(job_off[-1] + len(keys))
    all_keys = (
        np.concatenate(key_arrays) if key_arrays else np.zeros((0, 32), np.uint8)
    )
    flat_vals = b"".join(val_chunks)
    val_off = np.zeros((len(val_chunks) + 1,), dtype=np.uint64)
    if val_chunks:
        val_off[1:] = np.cumsum(
            np.fromiter((len(v) for v in val_chunks), dtype=np.uint64,
                        count=len(val_chunks))
        )
    vals_np = np.frombuffer(flat_vals, dtype=np.uint8) if flat_vals else np.zeros(1, np.uint8)
    job_off_np = np.asarray(job_off, dtype=np.uint64)
    err = ctypes.c_int32(0)
    h = lib.rtb_build(
        _ptr(np.ascontiguousarray(all_keys), _u8p), len(all_keys),
        _ptr(job_off_np, _u64p), len(jobs),
        _ptr(vals_np, _u8p), _ptr(val_off, _u64p),
        1 if collect_branches else 0, start_depth, ctypes.byref(err),
    )
    if not h:
        reason = {1: "unsorted", 2: "duplicate keys", 3: "bad input",
                  4: "oversized leaf value"}.get(err.value, "unknown")
        raise ValueError(f"triebuild failed (err={err.value}: {reason})")
    return h, key_arrays


def sweep_levels(jobs, collect_branches: bool = False, start_depth: int = 0) -> list[_Level]:
    """The native sweep's per-level arrays for ``jobs``, deepest first (the
    levels a rebuild dispatches, one commit's slot namespace)."""
    lib = load_library()
    h, _ = _marshal_and_build(lib, jobs, collect_branches, start_depth)
    try:
        return [_Level(lib, h, i) for i in range(lib.rtb_num_levels(h))]
    finally:
        lib.rtb_free(h)


# -- pipelined rebuild --------------------------------------------------------


class _SweepResult:
    """One sweep group's host arrays, extracted from the native handle so
    the handle can be freed inside the producer thread. Slots are the
    group's own 1..max_slot namespace; the consumer rebases them."""

    __slots__ = ("job_ids", "key_arrays", "levels", "root_slots",
                 "root_inlines", "meta_rec", "max_slot", "n_levels",
                 "wire_bytes", "hashed_nodes", "sweep_s")

    def __init__(self, job_ids, key_arrays, levels, root_slots, root_inlines,
                 meta_rec, max_slot, wire_bytes, sweep_s):
        self.job_ids = job_ids
        self.key_arrays = key_arrays
        self.levels = levels
        self.root_slots = root_slots
        self.root_inlines = root_inlines
        self.meta_rec = meta_rec
        self.max_slot = max_slot
        self.n_levels = len(levels)
        self.wire_bytes = wire_bytes
        self.hashed_nodes = sum(len(lv.row_slot) + len(lv.masks) for lv in levels)
        self.sweep_s = sweep_s


def _wire_bytes(lv) -> int:
    """Bytes of one swept level's arrays, as the reference counts them."""
    return (lv.flat.nbytes + lv.row_off.nbytes + lv.row_len.nbytes + lv.masks.nbytes
            + lv.children.nbytes)


def _sweep_group(lib, jobs, job_ids, collect_branches, start_depth) -> _SweepResult:
    """Producer body: native sweep of one job group (the ctypes call
    releases the GIL, so groups sweep concurrently) + array extraction."""
    t0 = time.perf_counter()
    h, key_arrays = _marshal_and_build(lib, jobs, collect_branches, start_depth)
    try:
        n_levels = lib.rtb_num_levels(h)
        levels = [_Level(lib, h, i) for i in range(n_levels)]
        root_slots = np.zeros((len(jobs),), dtype=np.int32)
        lib.rtb_roots(h, _ptr(root_slots, _i32p))
        root_inlines: list[bytes | None] = [None] * len(jobs)
        for j in range(len(jobs)):
            if root_slots[j] <= 0:
                ln = lib.rtb_root_inline_len(h, j)
                buf = np.zeros((ln,), dtype=np.uint8)
                if ln:
                    lib.rtb_root_inline(h, j, _ptr(buf, _u8p))
                root_inlines[j] = buf.tobytes()
        meta_rec = None
        if collect_branches:
            nmeta = int(lib.rtb_meta_count(h))
            meta_rec = np.zeros((nmeta, 80), dtype=np.uint8)
            if nmeta:
                lib.rtb_meta_get(h, _ptr(meta_rec, _u8p))
        max_slot = lib.rtb_max_slot(h)
    finally:
        lib.rtb_free(h)
    return _SweepResult(job_ids, key_arrays, levels, root_slots, root_inlines,
                        meta_rec, max_slot, sum(map(_wire_bytes, levels)),
                        time.perf_counter() - t0)


class _MergedLevel:
    """One dispatch worth of same-depth rows packed across subtrie sweeps
    (slots already rebased into the shared buffer)."""

    __slots__ = ("depth", "flat", "row_off", "row_len", "row_slot", "holes",
                 "b_tier", "masks", "bmp_slot", "children")


def _rebase_level(lv: _Level, base: int) -> None:
    """Shift a swept level's slot references into the shared slot space, in
    place: each _Level is consumed exactly once."""
    if base == 0:
        return
    if len(lv.row_slot):
        lv.row_slot += base
    if lv.holes is not None:
        lv.holes[2] += base
    if len(lv.bmp_slot):
        lv.bmp_slot += base
    if lv.children.shape[1]:
        lv.children[2] += base


def _pack_window(parts: list[tuple[int, _SweepResult]]) -> list[_MergedLevel]:
    """Merge the window's per-sweep levels by depth into one dispatch per
    (depth, kind), deepest first. Within a sweep deeper levels hash before
    their parents; across sweeps there is no ordering constraint."""
    by_depth: dict[int, list[_Level]] = {}
    for base, sw in parts:
        for lv in sw.levels:
            _rebase_level(lv, base)
            by_depth.setdefault(int(lv.depth), []).append(lv)
    out = []
    for depth in sorted(by_depth, reverse=True):
        group = by_depth[depth]
        m = _MergedLevel()
        m.depth = depth
        packed = [lv for lv in group if len(lv.row_slot)]
        if len(packed) == 1:
            lv = packed[0]
            m.flat, m.row_off, m.row_len = lv.flat, lv.row_off, lv.row_len
            m.row_slot, m.holes, m.b_tier = lv.row_slot, lv.holes, lv.b_tier
        elif packed:
            m.flat = np.concatenate([lv.flat for lv in packed])
            byte_off = np.cumsum([0] + [lv.flat.nbytes for lv in packed])
            row_cnt = np.cumsum([0] + [len(lv.row_slot) for lv in packed])
            m.row_off = np.concatenate(
                [lv.row_off + np.uint32(byte_off[i]) for i, lv in enumerate(packed)])
            m.row_len = np.concatenate([lv.row_len for lv in packed])
            m.row_slot = np.concatenate([lv.row_slot for lv in packed])
            holes = []
            for i, lv in enumerate(packed):
                if lv.holes is not None:
                    hs = lv.holes
                    hs[0] += np.int32(row_cnt[i])
                    holes.append(hs)
            m.holes = np.concatenate(holes, axis=1) if holes else None
            m.b_tier = max(lv.b_tier for lv in packed)
        else:
            m.flat = np.zeros((0,), dtype=np.uint8)
            m.row_off = m.row_len = np.zeros((0,), dtype=np.uint32)
            m.row_slot = np.zeros((0,), dtype=np.int32)
            m.holes, m.b_tier = None, 1
        bmp = [lv for lv in group if len(lv.bmp_slot)]
        if len(bmp) == 1:
            m.masks, m.bmp_slot, m.children = bmp[0].masks, bmp[0].bmp_slot, bmp[0].children
        elif bmp:
            mask_cnt = np.cumsum([0] + [len(lv.bmp_slot) for lv in bmp])
            m.masks = np.concatenate([lv.masks for lv in bmp])
            m.bmp_slot = np.concatenate([lv.bmp_slot for lv in bmp])
            kids = []
            for i, lv in enumerate(bmp):
                ch = lv.children
                if ch.shape[1]:
                    ch[0] += np.int32(mask_cnt[i])
                    kids.append(ch)
            m.children = (np.concatenate(kids, axis=1) if kids
                          else np.zeros((3, 0), dtype=np.int32))
        else:
            m.masks = np.zeros((0,), dtype=np.uint16)
            m.bmp_slot = np.zeros((0,), dtype=np.int32)
            m.children = np.zeros((3, 0), dtype=np.int32)
        out.append(m)
    return out


def _group_jobs(jobs, max_leaves: int, max_jobs: int):
    """Slice the job list into sweep groups bounded by leaves and job count,
    so sweeps stay small enough to overlap hashing."""
    groups = []
    lo = 0
    while lo < len(jobs):
        hi, leaves = lo, 0
        while hi < len(jobs) and (hi - lo) < max_jobs:
            leaves += len(jobs[hi][1])
            hi += 1
            if leaves >= max_leaves:
                break
        groups.append((lo, hi))
        lo = hi
    return groups


class RebuildPipeline:
    """Producer/consumer rebuild over the turbo commit path: a thread pool
    runs native sweeps for groups of subtries, feeding swept level arrays
    through a bounded queue; the consumer packs same-depth levels from
    different subtries into one dispatch each (``_pack_window``) against
    one growing digest buffer, so the host sweep of later groups overlaps
    the hashing of earlier ones. ``hash_workers > 1`` parallelises window
    hashing on the numpy twin (windows touch disjoint slot ranges); the
    device backend takes only 1.

    A knob left unset (None or 0) is read from the environment as in the
    reference: ``RETH_TPU_PIPELINE_SWEEPERS``, ``RETH_TPU_PIPELINE_HASHERS``,
    ``RETH_TPU_PIPELINE_WINDOW``, ``RETH_TPU_PIPELINE_SWEEP_LEAVES``.

    Faults, as in the reference: a supervised backend ("auto") that fails
    over mid-rebuild replays its journal on the numpy twin, and the
    pipeline goes on feeding it, inline from then on (``drained_windows``
    counts those windows); ``injector.on_pipeline_window()`` runs before
    each window, so ``RETH_TPU_FAULT_PIPELINE_ABORT`` kills the rebuild at
    a window boundary.

    A run reports as the reference's does: ``windows``, ``queue_peak`` and
    ``wire_bytes`` here, the stage times {sweep, pack, dispatch, fetch}
    through ``metrics.pipeline_metrics.record_run`` (``.last``), and the
    ``trie::pipeline`` spans ``rebuild`` and ``rebuild.window``. ``sweep``
    sums the sweep threads' own times, so it can exceed the wall."""

    def __init__(self, backend, lib=None, *, sweep_workers=None, hash_workers=1,
                 pack_window=None, queue_depth=None, leaves_per_sweep=None,
                 jobs_per_sweep=None, injector=None):
        env = os.environ
        self.backend = backend
        self.lib = lib or load_library()
        self.sweep_workers = int(sweep_workers or env.get("RETH_TPU_PIPELINE_SWEEPERS", 0)
                                 or max(2, min(4, os.cpu_count() or 1)))
        self.hash_workers = max(1, int(hash_workers or env.get("RETH_TPU_PIPELINE_HASHERS", 1)))
        self.pack_window = int(pack_window or env.get("RETH_TPU_PIPELINE_WINDOW", 0) or 16)
        self.queue_depth = int(queue_depth or 2 * self.sweep_workers)
        self.leaves_per_sweep = int(leaves_per_sweep
                                    or env.get("RETH_TPU_PIPELINE_SWEEP_LEAVES", 0) or 32768)
        self.jobs_per_sweep = int(jobs_per_sweep or 64)
        self.injector = injector
        self.windows = 0
        self.queue_peak = 0
        self.wire_bytes = 0

    def run(self, jobs, collect_branches: bool = False, start_depth: int = 0):
        if not jobs:
            return []
        t_wall = time.perf_counter()
        met = pipeline_metrics
        groups = _group_jobs(jobs, self.leaves_per_sweep, self.jobs_per_sweep)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.queue_depth)
        stop = threading.Event()
        busy = [0]
        busy_lock = threading.Lock()
        lib, backend = self.lib, self.backend

        def task(lo: int, hi: int):
            if stop.is_set():
                return
            with busy_lock:
                busy[0] += 1
                met.set_pool_busy(busy[0])
            try:
                out = _sweep_group(lib, jobs[lo:hi], range(lo, hi),
                                   collect_branches, start_depth)
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                out = e
            finally:
                with busy_lock:
                    busy[0] -= 1
                    met.set_pool_busy(busy[0])
            while not stop.is_set():
                try:
                    q.put(out, timeout=0.05)
                    met.set_queue_depth(q.qsize())
                    return
                except queue_mod.Full:
                    continue

        pool = ThreadPoolExecutor(max_workers=self.sweep_workers,
                                  thread_name_prefix="trie-sweep")
        hash_pool = (ThreadPoolExecutor(max_workers=self.hash_workers,
                                        thread_name_prefix="trie-hash")
                     if self.hash_workers > 1 else None)
        stages = {"sweep": 0.0, "pack": 0.0, "dispatch": 0.0, "fetch": 0.0}
        results: list = [None] * len(jobs)
        swept: list[tuple[int, _SweepResult]] = []  # (slot_base, sweep)
        pending: list = []
        next_slot = [1]
        ensured = [0]
        drained = [0]
        trace_ctx = tracing.current_context()

        def flush(window: list[_SweepResult]) -> None:
            t0 = time.perf_counter()
            parts = []
            for sw in window:
                base = next_slot[0] - 1  # group slot s -> shared slot base+s
                next_slot[0] += sw.max_slot
                parts.append((base, sw))
                swept.append((base, sw))
            merged = _pack_window(parts)
            stages["pack"] += time.perf_counter() - t0
            hwm = next_slot[0] - 1
            if hwm > ensured[0]:
                for f in pending:
                    f.result()
                del pending[:]
                want = max(hwm, 2 * ensured[0])
                backend.ensure(want)
                ensured[0] = want
            if self.injector is not None:
                self.injector.on_pipeline_window()
            failed_over = getattr(backend, "failed_over", False)

            def dispatch():
                t1 = time.perf_counter()
                t1_wall = time.time()
                for m in merged:
                    backend.dispatch_packed(m.flat, m.row_off, m.row_len,
                                            m.row_slot, m.holes, m.b_tier)
                    backend.dispatch_branch(m.masks, m.bmp_slot, m.children)
                backend.flush_window()
                dt = time.perf_counter() - t1
                stages["dispatch"] += dt
                # the window may run on the hash pool: attribute it to the
                # rebuild's trace explicitly
                tracing.record_span("trie::pipeline", "rebuild.window", t1_wall, dt,
                                    ctx=trace_ctx,
                                    fields={"levels": len(merged), "subtries": len(window)})

            if hash_pool is not None and not failed_over:
                pending.append(hash_pool.submit(dispatch))
            else:
                dispatch()
            if getattr(backend, "failed_over", False):
                drained[0] += 1
            self.windows += 1

        try:
            backend.begin(0)
            for lo, hi in groups:
                pool.submit(task, lo, hi)
            remaining = len(groups)
            while remaining:
                sw = q.get()
                self.queue_peak = max(self.queue_peak, q.qsize() + 1)
                met.set_queue_depth(q.qsize())
                if isinstance(sw, BaseException):
                    raise sw
                remaining -= 1
                stages["sweep"] += sw.sweep_s
                self.wire_bytes += sw.wire_bytes
                window = [sw]
                # fill the window with whatever has already been swept —
                # never wait: overlap beats packing width
                while len(window) < self.pack_window and remaining:
                    try:
                        sw2 = q.get_nowait()
                    except queue_mod.Empty:
                        break
                    if isinstance(sw2, BaseException):
                        raise sw2
                    remaining -= 1
                    stages["sweep"] += sw2.sweep_s
                    self.wire_bytes += sw2.wire_bytes
                    window.append(sw2)
                flush(window)
            for f in pending:
                f.result()
            del pending[:]
            return self._collect(swept, results, collect_branches, start_depth, stages)
        finally:
            stop.set()
            pool.shutdown(wait=True)
            if hash_pool is not None:
                hash_pool.shutdown(wait=True)
            while True:  # unblock producers stuck on a full queue
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break
            met.set_queue_depth(0)
            wall_s = time.perf_counter() - t_wall
            met.record_run(jobs=len(jobs), groups=len(groups), windows=self.windows,
                           queue_peak=self.queue_peak, drained_windows=drained[0],
                           backend=getattr(backend, "effective_kind", None),
                           wall_s=wall_s, **stages)
            tracing.record_span("trie::pipeline", "rebuild", time.time() - wall_s, wall_s,
                                ctx=trace_ctx,
                                fields={"jobs": len(jobs), "windows": self.windows,
                                        **{k: round(v, 4) for k, v in stages.items()}})

    def _collect(self, swept, results, collect_branches, start_depth, stages):
        t0 = time.perf_counter()
        backend = self.backend
        if collect_branches:
            digests = backend.finish()
            roots_raw = None
        else:
            digests = None
            flat_slots = np.concatenate([
                np.where(sw.root_slots > 0, sw.root_slots + base, 0)
                for base, sw in swept]) if swept else np.zeros((0,), np.int32)
            roots_raw = backend.fetch_slots(flat_slots)
        cursor = 0
        total_hashed = 0
        for base, sw in swept:
            total_hashed += sw.hashed_nodes
            for k, j in enumerate(sw.job_ids):
                slot = int(sw.root_slots[k])
                if slot > 0:
                    root = (digests[base + slot] if digests is not None
                            else roots_raw[cursor + k]).tobytes()
                else:
                    inline = sw.root_inlines[k]
                    root = keccak256(inline) if inline else EMPTY_ROOT_HASH
                results[j] = TrieBuildResult(root=root, levels=sw.n_levels)
            cursor += len(sw.job_ids)
        if results:
            results[-1].hashed_nodes = total_hashed
        if collect_branches:
            for base, sw in swept:
                if sw.meta_rec is None or not len(sw.meta_rec):
                    continue
                job_starts = np.cumsum([0] + [len(k) for k in sw.key_arrays])
                group_results = [results[j] for j in sw.job_ids]
                _collect_meta_records(sw.meta_rec, sw.key_arrays, job_starts,
                                      digests, group_results, start_depth,
                                      slot_base=base)
        stages["fetch"] += time.perf_counter() - t0
        return results


class TurboCommitter:
    """Full-rebuild state committer over 32-byte hashed keys.

    ``backend``: "device" (the fused engines of ``ops.fused_commit`` on
    ``device``, the card by default), "numpy" (the CPU twin) or "auto" (the
    device engine under ``supervisor``, else ``DeviceSupervisor.shared()``:
    the watchdog, the breaker and the journaled mid-commit failover onto
    the twin, ``ops/supervisor.py SupervisedBackend``; its k-level engines
    arm their own ladder too). On "device" the twin never stands in for a
    failed device: a failed launch raises. The device engine is, as in the
    reference on one device, ``MegaFusedEngine`` (each commit staged and
    uploaded in two copies, one launch per level), or
    ``SubtrieFusedEngine(k)`` for ``subtrie_levels`` k > 1 (one launch per
    chunk of k levels). ``subtrie_levels=None`` reads
    ``RETH_TPU_SUBTRIE_LEVELS`` (unset: 0). The k-level engine is gated by
    the warm-up manager attached to ``supervisor``, if any.

    ``hash_service`` (an ``ops/hash_service.py HashService``): each device
    commit ("device" or "auto") holds the service's exclusive lease from
    ``begin`` to its terminal fetch (``lease_backend``), and drops it when
    the commit aborts or fails; the coalesced lanes pause meanwhile, and
    their aged requests bypass onto the twin. On a meshed service
    (``HashService(mesh=)``) the lease is a sub-mesh lease: the commit's
    engine forms over the k members the lease carved out
    (``rebuild_mesh()``) while the live lanes keep the rest. The numpy
    backend takes no lease.

    ``mesh`` (a ``parallel/mesh.py`` HashMesh, or one of its ``Mesh``
    memberships): the device engine shards each level's rows over its live
    members (``ops/fused_commit.py FusedMeshEngine``, or
    ``SubtrieMeshEngine`` for k > 1); taken from the hash service when not
    given. A sub-mesh lease held by the commit wins over it."""

    def __init__(self, backend: str = "device", min_tier: int = 1024, mesh=None,
                 supervisor=None, hash_service=None, subtrie_levels: int | None = None,
                 device: str | torch.device = "cuda"):
        if backend not in ("device", "numpy", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is None and hash_service is not None:
            mesh = getattr(hash_service, "mesh", None)
        self.mesh = mesh
        self.supervisor = supervisor
        self.hash_service = hash_service
        if subtrie_levels is None:
            subtrie_levels = int(os.environ.get("RETH_TPU_SUBTRIE_LEVELS", "0") or 0)
        self.subtrie_levels = max(0, int(subtrie_levels))
        self.backend_kind = backend
        self.min_tier = min_tier
        # the numpy twin needs no card; the device backends check for one now
        self.device = resolve(device) if backend != "numpy" else None
        self.arena = DigestArena()  # resident across this committer's commits
        self._lib = load_library()

    def _device_engine(self, ladder: bool = False) -> MegaFusedEngine:
        """A commit's device engine; ``ladder`` arms the k-level engine's
        fault ladder, which only the supervised route asks for. Over the
        sub-mesh the service leased to this commit, else over ``mesh``, the
        engine is a mesh engine."""
        svc = self.hash_service
        sub = svc.rebuild_mesh() if svc is not None and hasattr(svc, "rebuild_mesh") else None
        mesh = sub if sub is not None else self.mesh
        if mesh is not None:
            if self.subtrie_levels > 1:
                return SubtrieMeshEngine(mesh, min_tier=self.min_tier, k=self.subtrie_levels,
                                         warmup=getattr(self.supervisor, "warmup", None),
                                         ladder=ladder)
            return FusedMeshEngine(mesh, min_tier=self.min_tier)
        if self.subtrie_levels > 1:
            return SubtrieFusedEngine(min_tier=self.min_tier, k=self.subtrie_levels,
                                      warmup=getattr(self.supervisor, "warmup", None),
                                      ladder=ladder, device=self.device)
        return MegaFusedEngine(min_tier=self.min_tier, device=self.device)

    def _make_backend(self):
        if self.backend_kind == "numpy":
            return _NumpyBackend(arena=self.arena)

        def build():
            if self.backend_kind == "auto":
                return SupervisedBackend(self.supervisor or DeviceSupervisor.shared(),
                                         functools.partial(self._device_engine, ladder=True),
                                         arena=self.arena, device=self.device)
            return self._device_engine()

        if self.hash_service is not None:
            # the shared service's discipline: this commit holds the card
            # through the service's lease, built once the lease is held
            return self.hash_service.lease_backend(factory=build)
        return build()

    def commit_hashed_many(
        self,
        jobs: list[tuple[np.ndarray, list[bytes]]],
        collect_branches: bool = False,
        start_depth: int = 0,
    ) -> list[TrieBuildResult]:
        """Commit many independent secure tries with shared level batching.

        ``jobs``: (keys (n, 32) uint8 — need not be sorted, values aligned
        RLP-encoded bytes) per trie. ``start_depth`` builds each job as the
        subtrie below that nibble depth (keys must share the prefix).
        Returns one TrieBuildResult per job (root + optional BranchNode
        TrieUpdates, paths subtrie-relative)."""
        lib = self._lib
        h, key_arrays = _marshal_and_build(lib, jobs, collect_branches, start_depth)
        try:
            return self._run(lib, h, len(jobs), key_arrays, collect_branches, start_depth)
        finally:
            lib.rtb_free(h)

    def commit_hashed_pipelined(
        self,
        jobs: list[tuple[np.ndarray, list[bytes]]],
        collect_branches: bool = False,
        start_depth: int = 0,
        **knobs,
    ) -> list[TrieBuildResult]:
        """Overlapped variant of :meth:`commit_hashed_many` (same results
        bit for bit): sweep groups of subtries on a thread pool, pack
        same-depth levels across subtries into one dispatch, hash into one
        growing digest buffer. ``knobs`` are ``RebuildPipeline``'s.
        ``RETH_TPU_PIPELINE=0`` takes the serial path, as in the reference.
        The pipeline's fault injector is the supervisor's, else
        ``FaultInjector.from_env()``."""
        if not jobs:
            return []
        if len(jobs) == 1 or os.environ.get("RETH_TPU_PIPELINE", "1") == "0":
            return self.commit_hashed_many(jobs, collect_branches, start_depth)
        if self.backend_kind != "numpy":
            if int(knobs.get("hash_workers") or 1) > 1:
                raise ValueError("hash_workers > 1 is for the numpy backend: the device "
                                 "engine launches on one stream into one buffer, and the "
                                 "supervised journal is serial")
            knobs["hash_workers"] = 1
        t_start = time.time()
        backend = self._make_backend()
        injector = getattr(self.supervisor, "injector", None)
        if injector is None:
            injector = FaultInjector.from_env()
        pipe = RebuildPipeline(backend, self._lib, injector=injector, **knobs)
        try:
            results = pipe.run(jobs, collect_branches, start_depth)
        finally:
            _release(backend)  # an aborted commit drops the service's lease
        trie_metrics.record_commit(
            backend=backend.effective_kind, nodes=results[-1].hashed_nodes,
            levels=max(r.levels for r in results), leaves=sum(len(j[1]) for j in jobs),
            wire_bytes=pipe.wire_bytes, seconds=time.time() - t_start)
        return results

    def _run(self, lib, h, n_jobs, key_arrays, collect_branches, start_depth=0):
        t_start = time.time()
        backend = self._make_backend()
        try:
            return self._run_inner(lib, h, n_jobs, key_arrays, collect_branches, start_depth,
                                   backend, t_start)
        finally:
            _release(backend)  # a failed commit drops the service's lease

    def _run_inner(self, lib, h, n_jobs, key_arrays, collect_branches, start_depth, backend,
                   t_start):
        max_slot = lib.rtb_max_slot(h)
        backend.begin(max_slot)
        n_levels = lib.rtb_num_levels(h)
        total_hashed = 0
        wire_bytes = 0
        for i in range(n_levels):
            lv = _Level(lib, h, i)
            backend.dispatch_packed(lv.flat, lv.row_off, lv.row_len, lv.row_slot,
                                    lv.holes, lv.b_tier)
            backend.dispatch_branch(lv.masks, lv.bmp_slot, lv.children)
            total_hashed += len(lv.row_slot) + len(lv.masks)
            wire_bytes += _wire_bytes(lv)
        root_slots = np.zeros((n_jobs,), dtype=np.int32)
        lib.rtb_roots(h, _ptr(root_slots, _i32p))
        meta_rec = None
        if collect_branches:
            nmeta = int(lib.rtb_meta_count(h))
            meta_rec = np.zeros((nmeta, 80), dtype=np.uint8)
            if nmeta:
                lib.rtb_meta_get(h, _ptr(meta_rec, _u8p))
            digests = backend.finish()
        else:
            digests = None
            roots_raw = backend.fetch_slots(np.maximum(root_slots, 0))
        results = []
        for j in range(n_jobs):
            slot = int(root_slots[j])
            if slot > 0:
                root = (digests[slot] if digests is not None else roots_raw[j]).tobytes()
            else:
                ln = lib.rtb_root_inline_len(h, j)
                if ln == 0:
                    root = EMPTY_ROOT_HASH
                else:
                    buf = np.zeros((ln,), dtype=np.uint8)
                    lib.rtb_root_inline(h, j, _ptr(buf, _u8p))
                    root = keccak256(buf.tobytes())
            results.append(TrieBuildResult(root=root, levels=n_levels))
        if results:
            # the shared hash count is attributed to the batch
            results[-1].hashed_nodes = total_hashed
        trie_metrics.record_commit(
            backend=backend.effective_kind, nodes=total_hashed, levels=n_levels,
            leaves=sum(len(k) for k in key_arrays), wire_bytes=wire_bytes,
            seconds=time.time() - t_start)
        if collect_branches and meta_rec is not None and len(meta_rec):
            job_starts = np.cumsum([0] + [len(k) for k in key_arrays])
            _collect_meta_records(meta_rec, key_arrays, job_starts, digests,
                                  results, start_depth)
        return results


def _release(backend) -> None:
    """Drop a leased backend's lease (idempotent; other backends hold none)."""
    release = getattr(backend, "release", None)
    if release is not None:
        release()


def _collect_meta_records(meta_rec, key_arrays, job_starts, digests, results,
                          start_depth=0, slot_base=0):
    """Decode native BranchMeta records into per-job TrieUpdates.
    ``slot_base`` rebases the records' group-local digest slots into the
    pipeline's shared slot space."""
    jobs_f = meta_rec[:, 0:4].copy().view("<u4").ravel()
    reps = meta_rec[:, 4:8].copy().view("<u4").ravel()
    depths = meta_rec[:, 8:10].copy().view("<u2").ravel()
    smasks = meta_rec[:, 10:12].copy().view("<u2").ravel()
    tmasks = meta_rec[:, 12:14].copy().view("<u2").ravel()
    hmasks = meta_rec[:, 14:16].copy().view("<u2").ravel()
    cslots = meta_rec[:, 16:80].copy().view("<i4").reshape(-1, 16)
    for k in range(len(meta_rec)):
        j = int(jobs_f[k])
        keys = key_arrays[j]
        d = int(depths[k])
        key = keys[int(reps[k]) - int(job_starts[j])]  # rep_key is global
        nibs = np.empty((64,), dtype=np.uint8)
        nibs[0::2] = key >> 4
        nibs[1::2] = key & 0xF
        # BranchMeta depths are subtrie-relative; the stored path skips the
        # start_depth prefix nibbles of the full key
        path = bytes(nibs[start_depth : start_depth + d])
        hm = int(hmasks[k])
        hashes = tuple(
            digests[cslots[k, nb] + slot_base].tobytes()
            for nb in range(16) if (hm >> nb) & 1
        )
        results[j].branch_nodes[path] = BranchNode(
            int(smasks[k]), int(tmasks[k]), hm, hashes
        )
    return results
