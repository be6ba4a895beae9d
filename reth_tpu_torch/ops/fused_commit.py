"""Fused multi-level trie commit: child digests stay on the card between
levels, in one resident ``(S, 32)`` uint8 digest buffer.

Port of the JAX package's ``ops/fused_commit.py FusedLevelEngine``. The
committers hash a trie bottom-up, one level per dispatch, deepest first;
each dispatch reads child digests from the buffer and writes its own
digests into it, so the whole commit ends in one read-back (``finish`` or
``fetch_slots``). Slot 0 is a reserved dummy slot.

Three dispatch forms, as in the reference:

- ``dispatch_packed``: PACKED rows from the native sweep
  (``trie/turbo.py``) — kernel 2, ``csrc/fused_level.cu packed_level``.
- ``dispatch_branch``: BITMAP branch rows — kernel 3,
  ``csrc/fused_level.cu branch_level``.
- ``dispatch_level``: RLP templates with digest holes from
  ``trie/committer.py`` (the reference's ``_plain_level``/``_splice_level``
  XLA programs): a bucket of templates is a PACKED level with holes, so it
  goes through kernel 2 too. ``splice_level`` is its plain version in the
  reference's padded layout.

The reference pads every dispatch to batch/hole tiers (junk rows and holes
aimed at slot 0) so XLA compiles a bounded set of shapes, and splits levels
at row caps for its int32 indices. Neither applies here: each launch takes
the exact row count and 64-bit indices, so there is no padding to land
anywhere and no split.

Three engines, as in the reference. ``FusedLevelEngine`` uploads each
level's arrays and launches it at once. ``MegaFusedEngine`` (the rebuild's
default) stages every level of a commit and, at the end, uploads all of them
in two host-to-device copies (bytes and indices) and launches kernels 2 and
3 on views into those two buffers. ``SubtrieFusedEngine`` stages the same
way, but at every window runs each chunk of up to k levels as one launch of
kernel 4, ``csrc/fused_level.cu subtrie_levels``. Built for the supervised
route (``ladder=True``) it keeps the reference's fault ladder: a failed
chunk replays the commit's journal one level per launch, then on the numpy
twin (``SubtrieFaultInjector`` drills both rungs); elsewhere a failed launch
raises, as in the other engines.
Every launch is counted in ``metrics.fused_metrics``.

``DigestArena`` is the hot-state plane's device half: one
``SubtrieFusedEngine`` whose digest buffer stays on the card across blocks,
so that each block stages only its dirty rows (``begin_delta``) and splices
the digests earlier blocks wrote (``trie/sparse.py``'s arena finish).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .. import tracing
from ..device import resolve, stream_handle
from ..metrics import fused_metrics
from ..primitives.keccak import RATE
from . import _build
from .keccak import _next_tier, keccak256_words_masked_ref
from .warmup import DEFAULT_SUBTRIE_TIER


def _bytes_to_words(t: torch.Tensor) -> torch.Tensor:
    """(N, L) u8 rows -> (N, L//4) u32 little-endian words."""
    return t.contiguous().view(torch.uint32)


def _digests_to_bytes(d: torch.Tensor) -> torch.Tensor:
    """(N, 8) u32 digests -> (N, 32) u8 (little-endian per word)."""
    return d.contiguous().view(torch.uint8)


def _csr_rows(start: torch.Tensor) -> torch.Tensor:
    """Row index of every entry of a CSR index ``start`` (n+1,)."""
    n = start.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=start.device), start.diff())


def _csr_span(start: torch.Tensor) -> tuple[int, int]:
    """The entries a CSR index covers, ``[start[0], start[n])``. The kernels
    index the entry arrays by ``start``'s values, so a view of a level's
    rows (a mesh member's range) keeps the level's whole entry arrays and
    its own slice of ``start``; ``start[0]`` is 0 for a whole level."""
    return (int(start[0]), int(start[-1])) if start.shape[0] else (0, 0)


# -- kernel 2: one level of PACKED rows ---------------------------------------


def _padded_rows(flat, row_off, row_len, blocks: int | None = None):
    """(n, blocks * RATE) u8 rows gathered from ``flat``, each XORed with
    keccak's multi-rate padding at its own last rate block, and their (n,)
    int32 block counts ``row_len // RATE + 1``; ``blocks`` defaults to the
    largest count."""
    counts = (row_len // RATE + 1).to(torch.int32)
    L = (int(counts.max()) if blocks is None else blocks) * RATE
    col = torch.arange(L, device=flat.device)[None, :]
    idx = (row_off[:, None] + col).clamp(max=max(flat.shape[0] - 1, 0))
    rows = torch.where(col < row_len[:, None], flat[idx], 0).to(torch.uint8)
    rows ^= (col == row_len[:, None]).to(torch.uint8)
    rows ^= (col == (counts.long() * RATE - 1)[:, None]).to(torch.uint8) * 0x80
    return rows, counts


def packed_level_ref(flat, row_off, row_len, slots, hole_start, hole_off, hole_src, buf):
    """Plain PyTorch version of kernel 2 (the reference's ``_packed_level``):
    gather rows, XOR keccak padding, splice child digests, hash, scatter
    into ``buf`` in place."""
    rows, counts = _padded_rows(flat, row_off, row_len)
    L = rows.shape[1]
    h0, h1 = _csr_span(hole_start)
    if h1 > h0:
        hole_row = _csr_rows(hole_start)
        sidx = (hole_row * L + hole_off[h0:h1])[:, None] + torch.arange(32, device=buf.device)
        rows.view(-1)[sidx.reshape(-1)] = buf[hole_src[h0:h1]].reshape(-1)
    d = keccak256_words_masked_ref(_bytes_to_words(rows), counts)
    buf[slots] = _digests_to_bytes(d)


def _fused_lib() -> ctypes.CDLL:
    lib = _build.load_kernel("fused_level.cu")
    p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.packed_level.restype = c_int
    lib.packed_level.argtypes = [p, i64, p, p, p, p, p, p, p, i64, p]
    lib.branch_level.restype = c_int
    lib.branch_level.argtypes = [p, p, p, p, p, p, i64, p]
    lib.subtrie_levels.restype = c_int
    lib.subtrie_levels.argtypes = [p, p, p, c_int, p, p, p]
    lib.subtrie_levels_one_thread.restype = c_int
    lib.subtrie_levels_one_thread.argtypes = [p, p, p, c_int, p, p, p]
    lib.subtrie_levels_resident.restype = c_int
    lib.subtrie_levels_resident.argtypes = []
    lib.subtrie_levels_lanes5_rows.restype = i64
    lib.subtrie_levels_lanes5_rows.argtypes = []
    lib.keccak_perm_probe.restype = c_int
    lib.keccak_perm_probe.argtypes = [p, c_int, c_int, p]
    for fn in (lib.exchange_slots, lib.exchange_slots_warp_row):
        fn.restype = c_int
        fn.argtypes = [p, p, c_int, p, i64, p]
    lib.exchange_enable_peers.restype = c_int
    lib.exchange_enable_peers.argtypes = [p, c_int]
    return lib


_PACKED_TYPES = (torch.uint8, torch.int64, torch.int32, torch.int64, torch.int64,
                 torch.int32, torch.int64, torch.uint8)


def _check(name, tensors, types, buf):
    """Raise on any argument the kernels cannot take; they copy digests in
    16-byte chunks, so ``buf`` must start on a 16-byte boundary."""
    for t, ty in zip(tensors, types):
        if t.dtype != ty or not t.is_contiguous() or t.device != buf.device:
            raise ValueError(f"{name}: expected contiguous {ty} tensors on {buf.device}, "
                             f"got {t.dtype} on {t.device}")
    if buf.dim() != 2 or buf.shape[1] != 32:
        raise ValueError(f"{name}: digest buffer must be (S, 32) uint8")
    if buf.data_ptr() % 16:
        raise ValueError(f"{name}: digest buffer must be 16-byte aligned (16-byte copies)")


def packed_level(flat, row_off, row_len, slots, hole_start, hole_off, hole_src, buf):
    """Hash one level of PACKED rows into ``buf`` (kernel 2).

    ``flat`` u8: the level's concatenated row bytes; ``row_off`` i64 /
    ``row_len`` i32 / ``slots`` i64: per row; ``hole_start`` i64 (n+1,):
    each row's first hole (holes sorted by row; ``hole_start`` indexes the
    hole arrays, so it may start past 0); ``hole_off`` i32 / ``hole_src``
    i64: the hole's byte offset in its row and the buffer slot of the digest
    spliced there. ``buf``: (S, 32) u8, updated in place."""
    args = (flat, row_off, row_len, slots, hole_start, hole_off, hole_src, buf)
    _check("packed_level", args, _PACKED_TYPES, buf)
    # flat is read as aligned 8-byte words; it needs no slack past its end
    # (the kernel reads the word that runs past it only up to the end)
    if flat.data_ptr() % 8:
        raise ValueError("packed_level: flat must be 8-byte aligned (8-byte loads)")
    n = row_off.shape[0]
    if n == 0:
        return
    if buf.device.type == "cpu":
        packed_level_ref(*args)
        return
    ptrs = [t.data_ptr() for t in args]
    err = _fused_lib().packed_level(ptrs[0], flat.numel(), *ptrs[1:], n, stream_handle(buf))
    _build.check_launch(err, "packed_level")
    packed_level.launches += 1


packed_level.launches = 0


# -- kernel 3: one level of BITMAP branch rows --------------------------------


def branch_level_ref(masks, slots, ch_start, ch_nib, ch_src, buf):
    """Plain PyTorch version of kernel 3 (the reference's ``_branch_level``):
    build each branch RLP from its 16-bit mask, splice, pad, hash, scatter
    into ``buf`` in place."""
    n = masks.shape[0]
    dev = buf.device
    L = 4 * RATE
    nibs = torch.arange(16, device=dev)[None, :]
    present = (masks[:, None].long() >> nibs) & 1
    sizes = 1 + 32 * present
    csum = torch.cumsum(sizes, dim=1) - sizes
    payload = sizes.sum(dim=1) + 1
    hl = torch.where(payload > 0xFF, 3, 2)
    total = hl + payload
    rows = torch.zeros((n, L), dtype=torch.uint8, device=dev)
    rows[:, 0] = torch.where(hl == 3, 0xF9, 0xF8).to(torch.uint8)
    rows[:, 1] = torch.where(hl == 3, payload >> 8, payload & 0xFF).to(torch.uint8)
    # f9 rows: low length byte; f8 rows: overwritten by the first marker
    rows[:, 2] = (payload & 0xFF).to(torch.uint8)
    flat = rows.view(-1)
    base = torch.arange(n, device=dev)[:, None] * L
    flat[(base + hl[:, None] + csum).reshape(-1)] = torch.where(
        present == 1, 0xA0, 0x80).to(torch.uint8).reshape(-1)
    flat[base[:, 0] + total - 1] = 0x80
    c0, c1 = _csr_span(ch_start)
    if c1 > c0:
        ch_row = _csr_rows(ch_start)
        off = hl[ch_row] + csum[ch_row, ch_nib[c0:c1].long()] + 1
        sidx = (ch_row * L + off)[:, None] + torch.arange(32, device=dev)
        flat[sidx.reshape(-1)] = buf[ch_src[c0:c1]].reshape(-1)
    counts = total // RATE + 1
    col = torch.arange(L, device=dev)[None, :]
    rows ^= (col == total[:, None]).to(torch.uint8)
    rows ^= (col == (counts * RATE - 1)[:, None]).to(torch.uint8) * 0x80
    d = keccak256_words_masked_ref(_bytes_to_words(rows), counts.to(torch.int32))
    buf[slots] = _digests_to_bytes(d)


_BRANCH_TYPES = (torch.int32, torch.int64, torch.int64, torch.int32, torch.int64, torch.uint8)


def branch_level(masks, slots, ch_start, ch_nib, ch_src, buf):
    """Hash one level of BITMAP branch rows into ``buf`` (kernel 3).

    ``masks`` i32 (n,): 16-bit state masks; ``slots`` i64 (n,);
    ``ch_start`` i64 (n+1,): each row's first child (children sorted by
    row); ``ch_nib`` i32 / ``ch_src`` i64: the child's nibble and the
    buffer slot of its digest. ``buf``: (S, 32) u8, updated in place."""
    args = (masks, slots, ch_start, ch_nib, ch_src, buf)
    _check("branch_level", args, _BRANCH_TYPES, buf)
    n = masks.shape[0]
    if n == 0:
        return
    if buf.device.type == "cpu":
        branch_level_ref(*args)
        return
    err = _fused_lib().branch_level(*(t.data_ptr() for t in args), n, stream_handle(buf))
    _build.check_launch(err, "branch_level")
    branch_level.launches += 1


branch_level.launches = 0


# -- kernel 4: a chunk of dependent levels in one launch -----------------------

# One row of the step table per staged level (int64): kind (0 packed, 1
# branch), rows, then byte offsets of the level's arrays in the two staged
# buffers, in csrc/fused_level.cu's StepField order.
_PARAM_W = 10
(_KIND, _ROWS, _BYTES, _BYTES_LEN, _ROW_OFF, _ROW_LEN, _SLOTS, _START, _TAG,
 _SRC) = range(_PARAM_W)


def _step_args(u8: torch.Tensor, idx: torch.Tensor, p, n_entries: int | None = None) -> tuple:
    """The level kernel's arguments (all but ``buf``) for one step-table
    row ``p``: views into the staged byte buffer ``u8`` and index buffer
    ``idx``. ``n_entries`` is the level's hole (child) count; without it it
    is read from the end of the CSR start index."""
    n = p[_ROWS]

    def ix(off: int, count: int, dtype) -> torch.Tensor:
        size = torch.empty((), dtype=dtype).element_size()
        return idx[off:off + count * size].view(dtype)

    start = ix(p[_START], n + 1, torch.int64)
    h = int(start[n]) if n_entries is None else n_entries
    tail = (ix(p[_SLOTS], n, torch.int64), start, ix(p[_TAG], h, torch.int32),
            ix(p[_SRC], h, torch.int64))
    if p[_KIND] == 0:
        return (u8[p[_BYTES]:p[_BYTES] + p[_BYTES_LEN]], ix(p[_ROW_OFF], n, torch.int64),
                ix(p[_ROW_LEN], n, torch.int32), *tail)
    return (u8[p[_BYTES]:p[_BYTES] + 4 * n].view(torch.int32), *tail)


def subtrie_levels_ref(u8, idx, steps, rows, buf):
    """Plain PyTorch version of kernel 4 (the reference's
    ``_subtrie_program``): the chunk's levels in order, each through its
    level kernel's plain version on views into the staged buffers."""
    for p in steps.tolist():
        ref = packed_level_ref if p[_KIND] == 0 else branch_level_ref
        ref(*_step_args(u8, idx, p), buf)


def subtrie_levels(u8, idx, steps, rows, buf):
    """Hash a chunk of dependent levels into ``buf`` in one launch (kernel 4).

    ``u8`` / ``idx``: the staged byte and index buffers (u8, 16-byte
    aligned); ``steps``: (k, _PARAM_W) i64 step table on the same device,
    one row per level, deepest first; ``rows``: (k,) int64 numpy array on
    the host, each step's row count (the kernel picks each step's path by
    it and sizes the grid from it). ``buf``: (S, 32) u8, updated in place."""
    for name, t in (("u8", u8), ("idx", idx)):
        if t.dtype != torch.uint8 or t.dim() != 1 or t.device != buf.device:
            raise ValueError(f"subtrie_levels: {name} must be a 1-D uint8 tensor on {buf.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"subtrie_levels: {name} must be 16-byte aligned")
    if (steps.dtype != torch.int64 or steps.dim() != 2 or steps.shape[1] != _PARAM_W
            or not steps.is_contiguous() or steps.device != buf.device):
        raise ValueError(f"subtrie_levels: steps must be a contiguous (k, {_PARAM_W}) int64 "
                         f"tensor on {buf.device}")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.shape != (steps.shape[0],):
        raise ValueError(f"subtrie_levels: rows must hold one count per step "
                         f"({steps.shape[0]}), got shape {rows.shape}")
    _check("subtrie_levels", (), (), buf)
    if steps.shape[0] == 0 or not rows.any():
        return
    if buf.device.type == "cpu":
        subtrie_levels_ref(u8, idx, steps, rows, buf)
        return
    err = _fused_lib().subtrie_levels(u8.data_ptr(), idx.data_ptr(), steps.data_ptr(),
                                      steps.shape[0], rows.ctypes.data, buf.data_ptr(),
                                      stream_handle(buf))
    _build.check_launch(err, "subtrie_levels")
    subtrie_levels.launches += 1


subtrie_levels.launches = 0


def subtrie_resident_blocks() -> int:
    """Blocks of kernel 4 the card holds at once: the grid of its largest
    launches (each block 128 rows of a wide level at a time, 16 of a
    narrow one)."""
    n = _fused_lib().subtrie_levels_resident()
    if n <= 0:
        raise RuntimeError(f"subtrie_levels: occupancy query failed (CUDA error {-n})")
    return n


def subtrie_lanes5_rows() -> int:
    """The largest step kernel 4 runs on its five-lane path on this card
    (the co-resident blocks x 16 rows); larger steps take one thread a row."""
    n = _fused_lib().subtrie_levels_lanes5_rows()
    if n <= 0:
        raise RuntimeError(f"subtrie_levels: occupancy query failed (CUDA error {-n})")
    return n


# -- the mesh's digest exchange ---------------------------------------------------

# the most members one exchange launch takes (csrc/fused_level.cu)
EXCHANGE_MAX_MEMBERS = 16
_peers_enabled: set[tuple[int, ...]] = set()


def _check_exchange(bufs, slots, bounds) -> int:
    m = len(bufs)
    if m == 0:
        raise ValueError("exchange_slots: no replicas")
    for b in bufs:
        _check("exchange_slots", (), (), b)
        if (b.shape != bufs[0].shape or not b.is_contiguous()
                or b.device.type != bufs[0].device.type):
            raise ValueError("exchange_slots: replicas must be contiguous (S, 32) uint8 tensors "
                             "of one shape and one device type")
    if (slots.dtype != torch.int64 or slots.dim() != 1 or not slots.is_contiguous()
            or slots.device != bufs[0].device):
        raise ValueError(f"exchange_slots: slots must be a contiguous 1-D int64 tensor on "
                         f"{bufs[0].device}")
    n = slots.shape[0]
    if (len(bounds) != m + 1 or bounds[0] != 0 or bounds[-1] != n
            or any(b > a for a, b in zip(bounds[1:], bounds[:-1]))):
        raise ValueError(f"exchange_slots: bounds must rise from 0 to {n} in {m + 1} steps, "
                         f"got {list(bounds)}")
    return n


def exchange_slots_ref(bufs, slots, bounds):
    """Plain PyTorch version of the exchange: for each member j, the rows at
    ``slots[bounds[j]:bounds[j+1]]`` of its replica ``bufs[j]`` are
    ``index_copy_``-ed into every other replica."""
    for j, src in enumerate(bufs):
        lo, hi = bounds[j], bounds[j + 1]
        if hi <= lo:
            continue
        ids = slots[lo:hi]
        rows = src.index_select(0, ids)
        for k, dst in enumerate(bufs):
            if k != j:
                dst.index_copy_(0, ids.to(dst.device), rows.to(dst.device))


def _exchange(entry: str, bufs, slots, bounds) -> bool:
    """Run one exchange: the plain version on CPU replicas, else ``entry``
    of ``csrc/fused_level.cu`` on the first replica's card (the current
    stream there), reaching replicas on other cards by peer access. True
    when it launched the kernel."""
    n = _check_exchange(bufs, slots, bounds)
    m = len(bufs)
    if m < 2 or n == 0:
        return False
    if bufs[0].device.type == "cpu":
        exchange_slots_ref(bufs, slots, bounds)
        return False
    if m > EXCHANGE_MAX_MEMBERS:
        raise ValueError(f"{entry}: {m} replicas, at most {EXCHANGE_MAX_MEMBERS}")
    lib = _fused_lib()
    cards = tuple(sorted({b.device.index for b in bufs}))
    if len(cards) > 1 and cards not in _peers_enabled:
        ids = (ctypes.c_int * len(cards))(*cards)
        _build.check_launch(lib.exchange_enable_peers(ids, len(cards)), "exchange_enable_peers")
        _peers_enabled.add(cards)
    ptrs = (ctypes.c_void_p * m)(*(b.data_ptr() for b in bufs))
    bnd = (ctypes.c_int64 * (m + 1))(*bounds)
    with torch.cuda.device(bufs[0].device):
        err = getattr(lib, entry)(ptrs, bnd, m, slots.data_ptr(), n, stream_handle(bufs[0]))
    _build.check_launch(err, entry)
    return True


def exchange_slots(bufs, slots, bounds):
    """Copy a level's digests between the mesh members' replicas
    (``csrc/fused_level.cu exchange_slots``): member j wrote the rows at
    ``slots[bounds[j]:bounds[j+1]]`` into its replica ``bufs[j]``; afterwards
    every replica holds every row. ``bufs``: (S, 32) u8 replicas, ``slots``:
    (n,) int64 on the first replica's device, ``bounds``: m + 1 ints on the
    host. CPU replicas run the plain version; CUDA replicas launch the
    kernel on the first replica's card (the current stream there), reaching
    replicas on other cards by peer access."""
    if _exchange("exchange_slots", bufs, slots, bounds):
        exchange_slots.launches += 1


exchange_slots.launches = 0


def exchange_slots_warp_row(bufs, slots, bounds):
    """The exchange's first design, one warp a row (``csrc/fused_level.cu
    exchange_slots_warp_row``), with ``exchange_slots``' arguments: a debug
    entry that chip_smoke.py times beside the kernel. No main path calls it;
    it counts its launches on its own."""
    if _exchange("exchange_slots_warp_row", bufs, slots, bounds):
        exchange_slots_warp_row.launches += 1


exchange_slots_warp_row.launches = 0


# -- template levels (TrieCommitter's bucket protocol) -------------------------


def splice_level(templates, counts, hole_row, hole_off, hole_src, slots, buf):
    """Plain version of the template levels (the reference's
    ``_plain_level``/``_splice_level``) in the reference's layout:
    ``templates`` (n, L) u8, padded on the host at each row's last rate
    block; splice the child digests at their (row, byte offset), hash with
    kernel 1's plain version, scatter the digests into ``buf`` in place.
    The port runs these levels through kernel 2 (``dispatch_level``); the
    tests and the smoke hold the two against each other."""
    if hole_row.shape[0]:
        L = templates.shape[1]
        sidx = (hole_row * L + hole_off)[:, None] + torch.arange(32, device=buf.device)
        templates.view(-1)[sidx.reshape(-1)] = buf[hole_src].reshape(-1)
    d = keccak256_words_masked_ref(_bytes_to_words(templates), counts)
    buf[slots] = _digests_to_bytes(d)


def padded_level(flat, row_off, row_len, slots, hole_start, hole_off, hole_src):
    """``splice_level``'s arguments (all but ``buf``) for a level given in
    kernel 2's: the rows padded in the reference's layout, L = the pow2
    block tier of the longest row (at least 2) times RATE, and each hole's
    row from the CSR start index."""
    tier = _next_tier(int((row_len // RATE + 1).max()), 2)
    templates, counts = _padded_rows(flat, row_off, row_len, tier)
    return templates, counts, _csr_rows(hole_start), hole_off.long(), hole_src, slots


class _Bucket:
    """One pending dispatch: template rows of one level."""

    __slots__ = ("templates", "counts", "slots", "holes", "nb_max")

    def __init__(self):
        self.templates: list[bytes] = []
        self.counts: list[int] = []
        self.slots: list[int] = []
        self.holes: list[tuple[int, int, int]] = []  # (row, byte_off, src_slot)
        self.nb_max = 1

    def add(self, template: bytes, nb: int, slot: int, holes) -> None:
        row = len(self.templates)
        self.templates.append(template)
        self.counts.append(nb)
        self.slots.append(slot)
        self.nb_max = max(self.nb_max, nb)
        for byte_off, src_slot in holes:
            self.holes.append((row, byte_off, src_slot))


def _csr(rows: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(order that sorts entries by row, (n+1,) per-row start index)."""
    order = np.argsort(rows, kind="stable")
    start = np.searchsorted(rows[order], np.arange(n + 1), side="left")
    return order, start.astype(np.int64)


class FusedLevelEngine:
    """Resident digest buffer + per-level dispatch.

    ``begin(max_slots)`` → dispatches, deepest level first → ``finish()``
    returns the (S, 32) numpy digest array, or ``fetch_slots`` returns just
    the rows asked for. Slot 0 is a reserved dummy. A level of more than
    ``MAX_BLOCK_TIER`` rate blocks raises ``ValueError``, the reference's
    declared ceiling of the warm-up menu (an MPT node takes at most 4)."""

    effective_kind = "device"  # the backend a commit's metrics name
    MAX_BLOCK_TIER = 64

    def __init__(self, min_tier: int = 1024, device: str | torch.device = "cuda"):
        self.min_tier = min_tier
        self.device = resolve(device)
        self._buf: torch.Tensor | None = None
        self._n_slots = 0
        self.uploads = 0  # host-to-device copies since begin()
        self.dispatches = 0  # launches since begin()
        # copy-growths of a resident buffer over the engine's life: how
        # many, the bytes they copied, and (on the card) each one's start
        # and end events, read by grow_ms()
        self.growths = 0
        self.grown_bytes = 0
        self._grow_events: list = []

    # -- lifecycle ---------------------------------------------------------

    def begin(self, max_slots: int) -> None:
        s_tier = _next_tier(max_slots + 1, max(self.min_tier, 2))
        self._buf = torch.zeros((s_tier, 32), dtype=torch.uint8, device=self.device)
        self._n_slots = 1  # slot 0 = dummy
        self.uploads = 0
        self.dispatches = 0

    def begin_from(self, buf: torch.Tensor) -> None:
        """Continue committing against ``buf`` (an (S, 32) u8 tensor on this
        engine's device, e.g. ``convert.digest_buffer_from_numpy`` of an
        earlier ``finish()``)."""
        if buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] != 32:
            raise ValueError("digest buffer must be (S, 32) uint8")
        if buf.device != self.device:
            raise ValueError(f"digest buffer is on {buf.device}, engine on {self.device}")
        self._buf = buf
        self._n_slots = buf.shape[0]

    def alloc_slot(self) -> int:
        slot = self._n_slots
        self._n_slots += 1
        return slot

    def ensure(self, max_slots: int) -> None:
        """Grow the buffer to hold ``max_slots`` slots, keeping written
        digests (pow2 growth)."""
        need = max_slots + 1
        cur = 0 if self._buf is None else self._buf.shape[0]
        if need <= cur:
            return
        events = None
        if cur and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        grown = torch.zeros((_next_tier(need, max(self.min_tier, 2, cur)), 32),
                            dtype=torch.uint8, device=self.device)
        if cur:
            grown[:cur] = self._buf
            self.growths += 1
            self.grown_bytes += cur * 32
            if events is not None:
                events[1].record()
                self._grow_events.append(events)
        self._buf = grown

    def grow_ms(self) -> float:
        """The card's time of every copy-growth so far (allocation and copy,
        by CUDA events; waits for the last one); 0 on the CPU."""
        if self._grow_events:
            self._grow_events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self._grow_events)

    def finish(self) -> np.ndarray:
        buf, self._buf = self._buf, None
        return buf.cpu().numpy()

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        """Read back only ``slots`` (e.g. per-job roots); ends the commit."""
        ids = self._put(np.asarray(slots, dtype=np.int64))
        out = self._buf.index_select(0, ids).cpu().numpy()
        self._buf = None
        return out

    def flush_window(self) -> None:
        """Window-boundary hook of the pipelined rebuild; this engine
        launches eagerly, so there is nothing to flush."""

    def _check_block_tier(self, b_tier: int) -> int:
        if b_tier > self.MAX_BLOCK_TIER:
            raise ValueError(f"node of {b_tier} rate blocks exceeds the declared block-tier "
                             f"ceiling {self.MAX_BLOCK_TIER} (ops/warmup.py shape menu)")
        return b_tier

    def _count_dispatch(self, levels: int = 1) -> None:
        """One launch ran, carrying ``levels`` staged levels."""
        self.dispatches += 1
        fused_metrics.record_dispatch(levels)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on this engine's device, 16-byte aligned as the level
        kernels need (on the CPU a numpy view may start anywhere)."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self.uploads += 1
        return t if t.data_ptr() % 16 == 0 else t.clone()

    # -- dispatch ----------------------------------------------------------

    def dispatch_level(self, bucket: _Bucket) -> None:
        """One level bucket of RLP templates (TrieCommitter's fused path),
        hashed as a PACKED level with holes by kernel 2: the templates
        concatenated, each row's offset and length, its slot, and the holes
        as (row, byte offset, source slot). The kernel pads each row at its
        own last rate block (``len // RATE + 1`` blocks, the committer's
        count, checked here) and then splices, as the reference pads on the
        host and splices on the device; a hole lies inside its template,
        so it never covers a padding byte."""
        n = len(bucket.templates)
        if n == 0:
            return
        lens = np.fromiter(map(len, bucket.templates), dtype=np.int64, count=n)
        if not np.array_equal(np.asarray(bucket.counts), lens // RATE + 1):
            raise ValueError("dispatch_level: a template's block count is not len // RATE + 1")
        row_off = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=row_off[1:])
        flat = np.frombuffer(bytearray().join(bucket.templates), dtype=np.uint8)
        holes = np.asarray(bucket.holes, dtype=np.int64).reshape(-1, 3).T
        self.dispatch_packed(flat, row_off, lens.astype(np.int32),
                             np.asarray(bucket.slots, dtype=np.int64), holes,
                             _next_tier(bucket.nb_max, 2))

    def dispatch_packed(self, flat: np.ndarray, row_off: np.ndarray, row_len: np.ndarray,
                        slots: np.ndarray, holes: np.ndarray | None, b_tier: int) -> None:
        """One level of packed RLP rows from the native sweep. ``holes``:
        (3, H) int32 [row, byte_off, src_slot] or None. ``b_tier`` is part
        of the engine protocol; the kernel takes each row's own block
        count, so it is not needed here."""
        n = len(row_off)
        if n == 0:
            return
        self._check_block_tier(b_tier)
        if holes is None:
            holes = np.zeros((3, 0), dtype=np.int32)
        order, start = _csr(holes[0], n)
        packed_level(
            self._put(flat), self._put(row_off.astype(np.int64)),
            self._put(row_len.astype(np.int32)), self._put(slots.astype(np.int64)),
            self._put(start), self._put(holes[1][order].astype(np.int32)),
            self._put(holes[2][order].astype(np.int64)), self._buf)
        self._count_dispatch()

    def dispatch_branch(self, masks: np.ndarray, slots: np.ndarray,
                        children: np.ndarray) -> None:
        """One level of all-hashed-children branches: 16-bit masks + child
        (row, nibble, src_slot) triples; the RLP is built on the card."""
        n = len(masks)
        if n == 0:
            return
        order, start = _csr(children[0], n)
        branch_level(
            self._put(masks.astype(np.int32)), self._put(slots.astype(np.int64)),
            self._put(start), self._put(children[1][order].astype(np.int32)),
            self._put(children[2][order].astype(np.int64)), self._buf)
        self._count_dispatch()


class _Staging:
    """One staged buffer in the making: parts at 16-byte boundaries (every
    view the kernels take then starts where ``_check`` needs it)."""

    def __init__(self):
        self.parts: list[tuple[int, np.ndarray]] = []
        self.size = 0

    def add(self, arr: np.ndarray) -> int:
        """Stage ``arr``'s bytes; returns their offset in the buffer."""
        b = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        off = self.size
        self.parts.append((off, b))
        self.size = off + -(-b.size // 16) * 16
        return off

    def fill(self, host: np.ndarray) -> None:
        for off, b in self.parts:
            host[off:off + b.size] = b


class MegaFusedEngine(FusedLevelEngine):
    """Whole-commit staging (the reference's ``MegaFusedEngine``): every
    dispatch of a commit is staged on the host, and the terminal fetch
    uploads all of them in two copies, one of bytes (packed rows, branch
    masks) and one of indices (every per-row, CSR and slot array), from
    pinned memory, then launches kernels 2 and 3 level by level on views
    into those two resident buffers. The digest buffer is allocated on the
    card, not uploaded.

    The staged layout is the port's own: what the level kernels take (row
    offsets computed on the host, holes and children sorted by row with a
    CSR start index), each part at a 16-byte boundary. ``staged_u8_bytes``
    / ``staged_i32_bytes`` count the bytes staged into each buffer (the
    index buffer holds i32 and i64 arrays), ``dispatches`` the level
    launches and ``uploads`` the host-to-device copies since ``begin``."""

    def __init__(self, min_tier: int = 1024, device: str | torch.device = "cuda"):
        super().__init__(min_tier=min_tier, device=device)
        self._s_tier = max(min_tier, 2)
        self._reset_staging()
        self._pinned: list[torch.Tensor] = []
        self.dispatches = 0
        self.staged_u8_bytes = 0
        self.staged_i32_bytes = 0

    def _reset_staging(self) -> None:
        # (b_tier, holes or children, step-table row) per staged level
        self._plan: list[tuple[int, int, tuple]] = []
        self._u8 = _Staging()
        self._idx = _Staging()

    def begin(self, max_slots: int) -> None:
        self._s_tier = _next_tier(max_slots + 1, max(self.min_tier, 2))
        self._n_slots = 1
        self._buf = None
        self._new_commit()

    def _new_commit(self) -> None:
        """Empty staging and zeroed per-commit counters."""
        self._reset_staging()
        self._pinned = []
        self.dispatches = 0
        self.uploads = 0
        self.staged_u8_bytes = 0
        self.staged_i32_bytes = 0

    def ensure(self, max_slots: int) -> None:
        """Before the first ``_execute`` the buffer is only a planned size,
        so growing it is free; after, the resident buffer is copy-grown."""
        if self._buf is None:
            self._s_tier = max(self._s_tier, _next_tier(max_slots + 1, max(self.min_tier, 2)))
        else:
            super().ensure(max_slots)

    # -- staging -----------------------------------------------------------

    def _stage_u8(self, arr: np.ndarray) -> int:
        off = self._u8.add(arr)
        self.staged_u8_bytes += arr.nbytes
        return off

    def _stage_idx(self, arr: np.ndarray) -> int:
        off = self._idx.add(arr)
        self.staged_i32_bytes += arr.nbytes
        return off

    def dispatch_packed(self, flat, row_off, row_len, slots, holes, b_tier) -> None:
        n = len(row_off)
        if n == 0:
            return
        self._check_block_tier(b_tier)
        if holes is None:
            holes = np.zeros((3, 0), dtype=np.int32)
        order, start = _csr(holes[0], n)
        flat = np.asarray(flat, dtype=np.uint8)
        p = (0, n, self._stage_u8(flat), flat.size,
             self._stage_idx(row_off.astype(np.int64)),
             self._stage_idx(row_len.astype(np.int32)),
             self._stage_idx(slots.astype(np.int64)), self._stage_idx(start),
             self._stage_idx(holes[1][order].astype(np.int32)),
             self._stage_idx(holes[2][order].astype(np.int64)))
        self._plan.append((b_tier, holes.shape[1], p))

    def dispatch_branch(self, masks, slots, children) -> None:
        n = len(masks)
        if n == 0:
            return
        order, start = _csr(children[0], n)
        p = (1, n, self._stage_u8(masks.astype(np.int32)), 0, 0, 0,
             self._stage_idx(slots.astype(np.int64)), self._stage_idx(start),
             self._stage_idx(children[1][order].astype(np.int32)),
             self._stage_idx(children[2][order].astype(np.int64)))
        self._plan.append((4, children.shape[1], p))

    # -- execution ---------------------------------------------------------

    def _stage_host(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The two staged buffers filled in pinned host memory, kept until
        the terminal fetch (which waits for the stream)."""
        out = []
        for stage in (self._u8, self._idx):
            host = torch.empty(max(stage.size, 16), dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
            stage.fill(host.numpy())
            self._pinned.append(host)
            out.append(host)
        return out[0], out[1]

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A filled pinned buffer on the engine's device, copied without
        blocking."""
        self.uploads += 1
        return host.to(self.device, non_blocking=True)

    def _upload(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The two staged buffers on the engine's device."""
        u8, idx = self._stage_host()
        return self._to_device(u8), self._to_device(idx)

    def _materialize(self) -> None:
        if self._buf is None:
            self._buf = torch.zeros((self._s_tier, 32), dtype=torch.uint8, device=self.device)

    def _execute(self) -> None:
        """Upload everything staged since the last execution, then launch
        its levels in order against the resident digest buffer."""
        self._materialize()
        if not self._plan:
            return
        u8, idx = self._upload()
        for _b_tier, n_entries, p in self._plan:
            args = _step_args(u8, idx, p, n_entries)
            (packed_level if p[_KIND] == 0 else branch_level)(*args, self._buf)
            self._count_dispatch()
        self._reset_staging()

    def pinned_bytes(self) -> int:
        """Bytes of pinned host staging the engine still holds."""
        return sum(t.numel() for t in self._pinned)

    def finish(self) -> np.ndarray:
        self._execute()
        out = super().finish()
        self._pinned = []
        return out

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        self._execute()
        out = super().fetch_slots(slots)
        self._pinned = []
        return out


class InjectedSubtrieWedge(RuntimeError):
    """Fault injection wedged a k-level chunk launch
    (RETH_TPU_FAULT_SUBTRIE_WEDGE): the engine replays its journal one level
    per launch."""


class InjectedSubtrieAbort(RuntimeError):
    """Fault injection poisoned the engine's whole device path
    (RETH_TPU_FAULT_SUBTRIE_ABORT): the chunk and its per-level replay both
    fail, so the commit lands on the numpy twin."""


class SubtrieFaultInjector:
    """Fault policies of the k-level engine (the reference's).

    ``wedge_at``: the Nth multi-level chunk launch of this injector raises
    :class:`InjectedSubtrieWedge` once; an engine with its ladder armed
    replays its journal on the per-level rung. ``abort_at``: the Nth chunk
    launch raises and so does every later per-level launch; the journal
    replays on the numpy twin. Without the ladder either fault raises out
    of the engine. Env form (:meth:`from_env`): ``RETH_TPU_FAULT_SUBTRIE_WEDGE`` /
    ``RETH_TPU_FAULT_SUBTRIE_ABORT``."""

    def __init__(self, wedge_at: int = 0, abort_at: int = 0):
        self.wedge_at = wedge_at
        self.abort_at = abort_at
        self.chunks = 0
        self.wedges = 0
        self.aborts = 0
        self._abort_armed = False
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> "SubtrieFaultInjector | None":
        env = os.environ if env is None else env
        wedge = int(env.get("RETH_TPU_FAULT_SUBTRIE_WEDGE", "0") or 0)
        abort = int(env.get("RETH_TPU_FAULT_SUBTRIE_ABORT", "0") or 0)
        if not (wedge or abort):
            return None
        return cls(wedge_at=wedge, abort_at=abort)

    def on_chunk(self, mode: str, levels: int) -> None:
        """Called before every ``subtrie_levels`` launch: ``mode`` is "fused"
        for a launch of a k-level plan, "perlevel" for a one-level replay."""
        if mode == "perlevel":
            with self._lock:
                armed = self._abort_armed
            if armed:
                tracing.fault_event("RETH_TPU_FAULT_SUBTRIE_ABORT", target="ops::fused_commit",
                                    rung="perlevel")
                raise InjectedSubtrieAbort(
                    "injected subtrie abort: per-level replay poisoned "
                    f"(RETH_TPU_FAULT_SUBTRIE_ABORT={self.abort_at})")
            return
        with self._lock:
            self.chunks += 1
            n = self.chunks
        if self.wedge_at and n == self.wedge_at:
            with self._lock:
                self.wedges += 1
            tracing.fault_event("RETH_TPU_FAULT_SUBTRIE_WEDGE", target="ops::fused_commit",
                                chunk=n, levels=levels)
            raise InjectedSubtrieWedge(f"injected subtrie wedge on chunk #{n} "
                                       f"(RETH_TPU_FAULT_SUBTRIE_WEDGE={self.wedge_at})")
        if self.abort_at and n == self.abort_at:
            with self._lock:
                self.aborts += 1
                self._abort_armed = True
            tracing.fault_event("RETH_TPU_FAULT_SUBTRIE_ABORT", target="ops::fused_commit",
                                chunk=n, levels=levels)
            raise InjectedSubtrieAbort(f"injected subtrie abort on chunk #{n} "
                                       f"(RETH_TPU_FAULT_SUBTRIE_ABORT={self.abort_at})")


class SubtrieFusedEngine(MegaFusedEngine):
    """Whole-subtrie k-level engine (the reference's ``SubtrieFusedEngine``
    on one card): staging as ``MegaFusedEngine``, but consecutive staged
    levels group into chunks of up to ``k`` and each chunk runs as ONE
    launch of kernel 4 (``subtrie_levels``), whose steps read digests the
    earlier steps wrote — launches per commit drop from O(depth) to
    O(depth / k). ``flush_window()`` executes each window of the pipelined
    rebuild at once (two copies, the step table staged with the indices),
    so the card hashes it while the host sweeps the next; the digest buffer
    stays resident across windows.

    A level of more than ``_CHUNK_BTIER_CAP`` block tier runs in a chunk of
    its own, and a chunk of one level launches kernel 4 too, as in the
    reference, so ``dispatches`` and ``levels_staged`` equal the
    reference engine's on the same staged plan.

    ``ladder=True`` (the supervised route, ``TurboCommitter(backend="auto")``,
    builds its engines so) arms the reference's fault ladder: fused chunks
    → per level → numpy twin. Each flush's staged host buffers and plan are
    journaled until the terminal fetch. A failed launch
    (``SubtrieFaultInjector``'s wedge, or a real fault) replays every
    journaled flush through ``subtrie_levels`` one level per launch on a
    fresh zeroed digest buffer; if that fails too (the injector's abort),
    the journal replays on the numpy twin, which decodes the port's staged
    plan and touches no CUDA tensor. Later flushes stay on the rung
    reached; ``fused_metrics.last["mode"]`` names it at the terminal fetch.
    Without ``ladder`` nothing is journaled and a failed launch, an
    injected fault included, raises out of ``flush_window`` / the terminal
    fetch after one attempt. A failed build raises either way: it is not a
    device fault.

    The hot-state arena (:class:`DigestArena`) keeps one engine, and its
    digest buffer on the card, across blocks: ``begin_delta`` opens a commit
    that keeps the buffer (holes may splice rows earlier commits wrote) and
    ``peek_slots`` reads back this commit's rows and keeps it. A delta commit
    never takes the ladder: its journal covers only the current commit, so a
    replay from a zeroed buffer would lose the resident rows; a failed launch
    raises to the arena's owner.

    ``warmup`` (an ``ops/warmup.py WarmupManager``) is asked at each flush
    whether the shape ("fused.subtrie", k, ``DEFAULT_SUBTRIE_TIER``) is
    warm; while it is not, the flush runs one level a launch, still on the
    card, and later flushes promote once it is. The reference's padding
    floors (``row_floor`` / ``hole_floor``) have no counterpart: the port
    launches exact row counts. ``SubtrieMeshEngine`` is the mesh variant."""

    _CHUNK_BTIER_CAP = 8

    def __init__(self, min_tier: int = 1024, k: int | None = None, warmup=None, injector=None,
                 ladder: bool = False, device: str | torch.device = "cuda"):
        super().__init__(min_tier=min_tier, device=device)
        self.warmup = warmup
        if k is None:
            k = int(os.environ.get("RETH_TPU_SUBTRIE_LEVELS", "0") or 8)
        self.k = max(1, int(k))
        self.injector = injector if injector is not None else SubtrieFaultInjector.from_env()
        self.ladder = ladder
        self.levels_staged = 0  # levels run since begin(), in `dispatches` launches
        self._mode = "fused"
        # per flush: (staged bytes, staged indices, plan, step table's offset
        # in the indices), host buffers kept until the terminal fetch
        self._journal: list[tuple[torch.Tensor, torch.Tensor, list, int]] = []
        self._buf_np: np.ndarray | None = None
        self._delta = False  # a begin_delta commit: launch faults raise, whatever the ladder

    @property
    def mode(self) -> str:
        """The rung this commit runs on: "fused", "perlevel" or "cpu"."""
        return self._mode

    def begin(self, max_slots: int) -> None:
        super().begin(max_slots)
        self._mode = "fused"

    def _new_commit(self) -> None:
        super()._new_commit()
        self.levels_staged = 0
        self._journal = []
        self._buf_np = None
        self._delta = False

    def begin_delta(self, max_slots: int) -> None:
        """Open a delta commit: keep the resident digest buffer of the
        previous commit and stage only this commit's rows, whose holes may
        splice slots earlier commits wrote; the buffer copy-grows to
        ``max_slots`` slots if it must. The engine must still be on the
        fused rung with a buffer on its device; anything else raises
        :class:`ArenaFault`, which the arena's owner answers with a full
        upload."""
        if self._mode != "fused" or self._buf is None:
            raise ArenaFault(f"delta precondition lost (mode={self._mode}, "
                             f"resident={self._buf is not None})")
        self._new_commit()
        self._delta = True
        self.ensure(max_slots)

    def ensure(self, max_slots: int) -> None:
        if self._mode != "cpu":
            super().ensure(max_slots)
            return
        need, cur = max_slots + 1, self._buf_np.shape[0]
        if need > cur:
            grown = np.zeros((_next_tier(need, max(self.min_tier, 2, cur)), 32), dtype=np.uint8)
            grown[:cur] = self._buf_np
            self._buf_np = grown

    def _chunk_plan(self, plan: list, k: int) -> list[tuple[int, int]]:
        """[(first step, steps)]: consecutive staged levels, up to ``k`` per
        chunk; a level above ``_CHUNK_BTIER_CAP`` (a branch level's block
        tier is 4) takes a chunk alone. The staging order is the dependency
        order (deeper levels first), so consecutive grouping keeps every
        parent after its children."""
        chunks: list[list[int]] = []
        cur_big = False
        for i, (b_tier, _, _) in enumerate(plan):
            big = b_tier > self._CHUNK_BTIER_CAP
            if chunks and len(chunks[-1]) < k and not big and not cur_big:
                chunks[-1].append(i)
            else:
                chunks.append([i])
            cur_big = big
        return [(c[0], len(c)) for c in chunks]

    def flush_window(self) -> None:
        """Execute everything staged so far (the pipelined rebuild calls
        this per window). The digest buffer stays resident."""
        self._execute()

    def _execute(self) -> None:
        plan = self._plan
        if not plan:
            if self._mode != "cpu":
                self._materialize()
            return
        if self._mode != "cpu" and self.device.type == "cuda":
            _fused_lib()  # a failed build raises here, outside the ladder
        u8, idx, plan, t_off = self._stage_flush()
        if self._mode == "cpu":
            self._run_plan_numpy(u8.numpy(), idx.numpy(), plan)
            return
        chunks = self._chunk_plan(plan, 1 if self._mode == "perlevel" else self.k)
        if (self._mode == "fused" and self.k > 1 and self.warmup is not None
                and not self.warmup.route_bucket("fused.subtrie", self.k, *self._route_key())):
            # degraded routing: the k-level shape is not warm, so this flush
            # runs one level a launch; the engine stays on "fused"
            fused_metrics.record_fallback()
            chunks = self._chunk_plan(plan, 1)
        # the reference's rule: a plan whose chunks are all single levels
        # counts as per-level for the injector
        mode = "perlevel" if self._mode == "perlevel" or len(chunks) >= len(plan) else "fused"
        try:
            self._materialize()
            self._run_chunks(u8, idx, t_off, plan, chunks, mode)
        except Exception as e:  # noqa: BLE001 — every launch fault takes the ladder
            if not self.ladder or self._delta or not self._ladder_takes(e):
                raise
            self._degrade(e)

    def _stage_flush(self) -> tuple[torch.Tensor, torch.Tensor, list, int]:
        """Everything staged since the last flush, with the step table
        staged among the indices, in two host buffers, returned as a journal
        entry (bytes, indices, plan, the step table's offset in the
        indices) and journaled when the ladder is armed."""
        plan = self._plan
        t_off = self._idx.add(np.array([p for _, _, p in plan], dtype=np.int64))
        u8, idx = self._stage_host()
        self._reset_staging()
        self.levels_staged += len(plan)
        if self.ladder:
            self._journal.append((u8, idx, plan, t_off))
        return u8, idx, plan, t_off

    def _chunk_args(self, u8: torch.Tensor, idx: torch.Tensor, t_off: int, plan: list,
                    chunks: list[tuple[int, int]]) -> list[tuple]:
        """Each chunk's ``subtrie_levels`` arguments but the digest buffer:
        the uploaded buffers, the chunk's rows of the step table on the
        device and its steps' row counts on the host (the launch's grid and
        each step's path follow from them)."""
        steps = idx[t_off:t_off + len(plan) * _PARAM_W * 8].view(torch.int64).view(-1, _PARAM_W)
        return [(u8, idx, steps[lo:lo + count],
                 np.array([p[_ROWS] for _, _, p in plan[lo:lo + count]], dtype=np.int64))
                for lo, count in chunks]

    def _route_key(self) -> tuple[int, int]:
        """(batch tier, member count) of this engine's k-level menu shape."""
        return DEFAULT_SUBTRIE_TIER, 1

    def _run_chunks(self, u8: torch.Tensor, idx: torch.Tensor, t_off: int, plan: list,
                    chunks: list[tuple[int, int]], mode: str) -> None:
        """Upload a flush's host buffers, then one launch of kernel 4 per
        chunk, each announced to the injector."""
        u8, idx = self._to_device(u8), self._to_device(idx)
        for args in self._chunk_args(u8, idx, t_off, plan, chunks):
            levels = args[2].shape[0]
            if self.injector is not None:
                self.injector.on_chunk(mode, levels)
            subtrie_levels(*args, self._buf)
            self._count_dispatch(levels)

    # -- fault ladder ---------------------------------------------------------

    def _ladder_takes(self, err: Exception) -> bool:
        """Does the armed ladder answer ``err`` (every launch fault does on one
        card; the mesh engine raises real kernel faults)?"""
        return True

    def _degrade(self, err: Exception) -> None:
        fused_metrics.record_fallback()
        if self._mode == "fused":
            tracing.fault_event("subtrie_fallback", target="ops::fused_commit", rung="perlevel",
                                error=f"{type(err).__name__}: {err}"[:200])
            self._mode = "perlevel"
            try:
                self._replay_journal_device()
                return
            except Exception as e2:  # noqa: BLE001 — the numpy rung below
                if not self._ladder_takes(e2):
                    raise
                fused_metrics.record_fallback()
                err = e2
        tracing.fault_event("subtrie_fallback", target="ops::fused_commit", rung="cpu",
                            error=f"{type(err).__name__}: {err}"[:200])
        slots = self._buf.shape[0] if self._buf is not None else self._s_tier
        self._mode = "cpu"
        self._buf = None
        self._buf_np = np.zeros((slots, 32), dtype=np.uint8)
        for u8, idx, plan, _ in self._journal:
            self._run_plan_numpy(u8.numpy(), idx.numpy(), plan)

    def _replay_journal_device(self) -> None:
        """Per-level rung: every journaled flush again, re-uploaded from its
        host buffers, through ``subtrie_levels`` one level per launch on a
        fresh zeroed digest buffer (hashing is deterministic, so the
        rebuilt buffer is bit-identical)."""
        slots = self._buf.shape[0] if self._buf is not None else self._s_tier
        self._buf = torch.zeros((slots, 32), dtype=torch.uint8, device=self.device)
        for u8, idx, plan, t_off in self._journal:
            self._run_chunks(u8, idx, t_off, plan, self._chunk_plan(plan, 1), "perlevel")

    def _run_plan_numpy(self, u8: np.ndarray, idx: np.ndarray, plan: list) -> None:
        """Numpy-twin rung: decode the staged plan (the port's layout: row
        offsets, lengths and slots per row, holes or children by row
        through a CSR start index) into the twin's dispatch arguments."""
        from ..trie.turbo import _NumpyBackend

        nb = _NumpyBackend()
        nb._buf = self._buf_np

        def ix(off: int, count: int, dtype) -> np.ndarray:
            return idx[off:off + count * np.dtype(dtype).itemsize].view(dtype)

        for b_tier, n_entries, p in plan:
            n = p[_ROWS]
            start = ix(p[_START], n + 1, np.int64)
            triples = np.stack([np.repeat(np.arange(n, dtype=np.int64), np.diff(start)),
                                ix(p[_TAG], n_entries, np.int32),
                                ix(p[_SRC], n_entries, np.int64)])
            slots = ix(p[_SLOTS], n, np.int64)
            if p[_KIND] == 0:
                nb.dispatch_packed(u8[p[_BYTES]:p[_BYTES] + p[_BYTES_LEN]],
                                   ix(p[_ROW_OFF], n, np.int64), ix(p[_ROW_LEN], n, np.int32),
                                   slots, triples if n_entries else None, b_tier)
            else:
                nb.dispatch_branch(u8[p[_BYTES]:p[_BYTES] + 4 * n].view(np.int32), slots,
                                   triples)

    # -- terminal fetches -------------------------------------------------------

    def _end(self) -> None:
        """Run what is left and record the commit (launches, levels, rung)."""
        self._execute()
        fused_metrics.record_commit(dispatches=self.dispatches, levels=self.levels_staged,
                                    k=self.k, mode=self._mode)
        self._journal = []

    def finish(self) -> np.ndarray:
        self._end()
        if self._mode == "cpu":
            buf, self._buf_np = self._buf_np, None
        else:
            buf = FusedLevelEngine.finish(self)
        self._pinned = []
        return buf

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        self._end()
        if self._mode == "cpu":
            out, self._buf_np = self._buf_np[np.asarray(slots, dtype=np.int64)], None
        else:
            out = FusedLevelEngine.fetch_slots(self, slots)
        self._pinned = []
        return out

    def peek_slots(self, slots: np.ndarray) -> np.ndarray:
        """Run what is staged and read back exactly ``slots``, as
        ``fetch_slots`` does, but keep the digest buffer on the card: the
        terminal fetch of an arena commit, whose rows later commits splice.
        The read-back waits for the stream, so the commit's pinned staging
        is released."""
        self._end()
        if self._mode == "cpu":  # an arena engine never takes the ladder
            return self._buf_np[np.asarray(slots, dtype=np.int64)].copy()
        ids = self._put(np.asarray(slots, dtype=np.int64))
        out = self._buf.index_select(0, ids).cpu().numpy()
        self._pinned = []
        return out


# -- the member mesh: rows sharded over members, the digest buffer replicated ----


class ReplicaMismatch(RuntimeError):
    """A mesh engine's replicas of the digest buffer differ after a commit."""


def _member_step(p, lo: int, hi: int) -> tuple:
    """Rows ``[lo, hi)`` of the staged level ``p`` (a step-table row) as a
    step-table row of its own: the per-row arrays advance to row ``lo``; the
    row bytes, and the entry arrays the CSR start index points into, stay
    whole (the kernels index them by the rows' own offsets and starts)."""
    q = list(p)
    q[_ROWS] = hi - lo
    q[_SLOTS] += 8 * lo
    q[_START] += 8 * lo
    if p[_KIND] == 0:
        q[_ROW_OFF] += 8 * lo
        q[_ROW_LEN] += 4 * lo
    else:
        q[_BYTES] += 4 * lo
    return tuple(q)


def _host_starts(idx: np.ndarray, p) -> np.ndarray:
    """The staged level ``p``'s CSR start index, read from the host buffer."""
    return idx[p[_START]:p[_START] + 8 * (p[_ROWS] + 1)].view(np.int64)


class MeshReplicas:
    """The mesh half of :class:`FusedMeshEngine` and :class:`SubtrieMeshEngine`
    (the reference shards each level's rows over a jax mesh and keeps the
    digest buffer replicated, XLA gathering each level's digests).

    The engine takes a ``parallel/mesh.py`` HashMesh, whose live membership
    it snapshots at construction (one commit, one membership), or a
    ``Mesh`` (a sub-mesh lease's). Each member keeps a replica of the digest
    buffer (``_buf`` is the first member's; setting it replicates it). A
    staged level runs as: each member's row range (``Mesh.ranges``) launched
    on the member's stream into its replica, then one ``exchange_slots``
    launch on the first member's stream, which waits for every member's
    launch; every member's next level waits for the exchange. The order is
    kept by CUDA events (``Stream.wait_stream``), never by host syncs. A
    flush's staged buffers are copied once to each distinct card of the
    mesh. ``member_launches`` and ``exchanges`` count what an engine
    launched. The terminal fetch first checks that every replica is
    byte-equal to the first member's (``ReplicaMismatch`` if not; counted in
    ``replicas_checked``), then reads the first member's."""

    def _init_mesh(self, mesh, min_tier: int) -> int:
        """Take the membership; returns ``min_tier`` rounded up to a multiple
        of the member count (as the reference rounds its tiers)."""
        live_snapshot = getattr(mesh, "live_snapshot", None)
        if live_snapshot is not None:
            mesh, _ = live_snapshot()
            if mesh is None:
                raise RuntimeError("HashMesh has no live devices")
        self.mesh = mesh
        self._replicas: list[torch.Tensor] = []
        self.member_launches = 0
        self.exchanges = 0
        self.replicas_checked = 0  # terminal fetches whose replicas were compared
        return -(-min_tier // mesh.size) * mesh.size

    @property
    def _buf(self):
        return self._replicas[0] if self._replicas else None

    @_buf.setter
    def _buf(self, t):
        if t is None:
            self._replicas = []
            return
        reps = [t] + [t.to(d, copy=True) for d in self.mesh.devices[1:]]
        for r in reps:
            self.mesh.keep(r)
        self._replicas = reps

    def _copy_to(self, host: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """A host buffer on ``dev``, copied on the caller's stream."""
        self.uploads += 1
        t = host.to(dev, non_blocking=True)
        self.mesh.keep(t)
        return t

    def _to_cards(self, host: torch.Tensor) -> dict:
        """``host`` copied once to each distinct card of the mesh."""
        out: dict = {}
        for d in self.mesh.devices:
            if d not in out:
                out[d] = self._copy_to(host, d)
        return out

    def _mesh_level(self, p, idx: dict, launch) -> None:
        """One staged level: ``launch(j, lo, hi)`` for each member with rows,
        on its stream, then the exchange of the level's slots (read from the
        first member's copy of the staged indices ``idx``)."""
        mesh = self.mesh
        n = p[_ROWS]
        ranges = mesh.ranges(n)
        for j, (lo, hi) in enumerate(ranges):
            if hi > lo:
                with mesh.on(j):
                    launch(j, lo, hi)
                self.member_launches += 1
        if len(self._replicas) < 2:
            return
        streams = mesh.streams
        slots = idx[mesh.devices[0]][p[_SLOTS]:p[_SLOTS] + 8 * n].view(torch.int64)
        with mesh.on(0):
            if streams[0] is not None:
                for s in streams[1:]:
                    streams[0].wait_stream(s)
            exchange_slots(self._replicas, slots, [lo for lo, _ in ranges] + [n])
        if streams[0] is not None:
            for s in streams[1:]:
                s.wait_stream(streams[0])
        self.exchanges += 1

    def _verify_replicas(self) -> None:
        if len(self._replicas) < 2:
            return
        first = self._replicas[0]
        for j, r in enumerate(self._replicas[1:], 1):
            if not torch.equal(first, r.to(first.device)):
                raise ReplicaMismatch(f"replica {j} of {len(self._replicas)} differs from "
                                      f"replica 0 after the commit")
        self.replicas_checked += 1

    def _ladder_takes(self, err: Exception) -> bool:
        return not _build.is_kernel_fault(err)


class FusedMeshEngine(MeshReplicas, MegaFusedEngine):
    """The fused level commit over a member mesh (the reference's
    ``FusedMeshEngine``): staged as ``MegaFusedEngine`` stages, executed at
    each window flush and at the terminal fetch. Each level's rows split
    into the members' ranges; each member launches kernel 2 (packed rows,
    and the template levels' route, ``dispatch_level``) or kernel 3 (branch
    rows) on its range into its own replica, then ``exchange_slots`` gives
    every replica the level's digests (see :class:`MeshReplicas`). A
    ``min_tier`` that the member count does not divide is rounded up, as in
    the reference. ``dispatches`` counts levels, as the single-card
    engines do; ``member_launches`` the launches."""

    def __init__(self, mesh, min_tier: int = 1024):
        min_tier = self._init_mesh(mesh, min_tier)
        super().__init__(min_tier=min_tier, device=self.mesh.devices[0])

    def flush_window(self) -> None:
        """Execute what the window staged (the digest buffer stays)."""
        self._execute()

    def _execute(self) -> None:
        self._materialize()
        if not self._plan:
            return
        plan = self._plan
        u8h, idxh = self._stage_host()
        self._reset_staging()
        idx_np = idxh.numpy()
        u8, idx = self._to_cards(u8h), self._to_cards(idxh)
        mesh = self.mesh
        mesh.fork()
        try:
            for _b_tier, _n_entries, p in plan:
                level = packed_level if p[_KIND] == 0 else branch_level
                starts = _host_starts(idx_np, p)

                def launch(j, lo, hi, p=p, level=level, starts=starts):
                    d = mesh.devices[j]
                    level(*_step_args(u8[d], idx[d], _member_step(p, lo, hi), int(starts[hi])),
                          self._replicas[j])

                self._mesh_level(p, idx, launch)
                self._count_dispatch()
        finally:
            mesh.join()

    def finish(self) -> np.ndarray:
        self._execute()
        self._verify_replicas()
        return super().finish()

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        self._execute()
        self._verify_replicas()
        return super().fetch_slots(slots)


class SubtrieMeshEngine(MeshReplicas, SubtrieFusedEngine):
    """The k-level engine over a member mesh (the reference's
    ``SubtrieMeshEngine``): staged and chunked as ``SubtrieFusedEngine``
    (the chunks of up to k levels, the injector's calls, ``dispatches`` one
    a chunk, the warm-up's ("fused.subtrie", k, tier, member count) shape
    with the tier rounded to the member count), but each staged level runs
    as one-step launches of kernel 4, one a member on its row range into its
    replica, with the exchange between steps: kernel 4's grid barrier spans
    one launch, and no barrier spans members. This matches the reference's
    per-step sharding constraint and all-gather; it costs a launch per
    member and an exchange per level where one card takes one launch per
    chunk (``member_launches``, ``exchanges``). A one-member mesh runs each
    chunk as one launch, as on one card. The fault ladder, when
    armed, answers injected faults as on one card; a real kernel fault
    raises."""

    def __init__(self, mesh, min_tier: int = 1024, k: int | None = None, warmup=None,
                 injector=None, ladder: bool = False):
        min_tier = self._init_mesh(mesh, min_tier)
        super().__init__(min_tier=min_tier, k=k, warmup=warmup, injector=injector,
                         ladder=ladder, device=self.mesh.devices[0])

    def _route_key(self) -> tuple[int, int]:
        m = self.mesh.size
        return -(-DEFAULT_SUBTRIE_TIER // m) * m, m

    def _run_chunks(self, u8h: torch.Tensor, idxh: torch.Tensor, t_off: int, plan: list,
                    chunks: list[tuple[int, int]], mode: str) -> None:
        mesh = self.mesh
        if mesh.size == 1:
            # one member: no barrier has to span members, so each chunk is
            # one launch, as on one card
            super()._run_chunks(u8h, idxh, t_off, plan, chunks, mode)
            self.member_launches += len(chunks)
            return
        idx_np = idxh.numpy()
        # each member's rows of each step as a step table of its own
        table = np.zeros((len(plan), mesh.size, _PARAM_W), dtype=np.int64)
        rows = np.zeros((len(plan), mesh.size), dtype=np.int64)
        for s, (_, _, p) in enumerate(plan):
            for j, (lo, hi) in enumerate(mesh.ranges(p[_ROWS])):
                table[s, j] = _member_step(p, lo, hi)
                rows[s, j] = hi - lo
        u8, idx = self._to_cards(u8h), self._to_cards(idxh)
        steps = self._to_cards(torch.from_numpy(table))
        mesh.fork()
        try:
            for first, count in chunks:
                if self.injector is not None:
                    self.injector.on_chunk(mode, count)
                for s in range(first, first + count):
                    def launch(j, lo, hi, s=s):
                        d = mesh.devices[j]
                        subtrie_levels(u8[d], idx[d], steps[d][s, j:j + 1], rows[s, j:j + 1],
                                       self._replicas[j])

                    self._mesh_level(plan[s][2], idx, launch)
                self._count_dispatch(count)
        finally:
            mesh.join()

    def finish(self) -> np.ndarray:
        self._execute()
        self._verify_replicas()
        return super().finish()

    def fetch_slots(self, slots: np.ndarray) -> np.ndarray:
        self._execute()
        self._verify_replicas()
        return super().fetch_slots(slots)


# -- hot-state plane, device half: the persistent digest arena -----------------


class ArenaFault(RuntimeError):
    """A delta commit's precondition is lost, or a device fault hit it,
    under the hot-state arena. The engine never handles it (its journal
    covers only the current commit, so its replay cannot rebuild resident
    rows): the arena's owner catches it, evicts, and reruns the commit on
    the classic finish."""


class DigestArena:
    """Epoch-tagged registry of the digest rows resident in one
    :class:`SubtrieFusedEngine` that outlives the block: the hot-state
    plane's device half (the reference's ``DigestArena``).

    The classic sparse finish builds an engine per commit, stages its whole
    dirty set, and the buffer dies with the read-back. Under the arena the
    engine and its buffer on the card survive: slots are allocated
    monotonically across epochs, ``_slot_of`` maps a node digest to (slot,
    last live epoch), and a new epoch's templates hole-splice resident
    slots for unchanged children instead of carrying their digests as
    literal bytes. The terminal fetch is :meth:`SubtrieFusedEngine
    .peek_slots` (this epoch's rows only), which keeps the buffer.

    Safety (roots are bit-identical on every rung):

    - ``begin_delta`` refuses unless the engine is still on the fused rung
      with a buffer (:class:`ArenaFault`);
    - a fault in any epoch raises out of the engine; :meth:`on_fault`
      evicts and the owner reruns the commit on the classic finish, on the
      same device;
    - rows idle for ``max_epoch_age`` epochs retire at lookup, and the
      whole arena evicts once ``next_slot`` reaches ``max_rows``, so the
      buffer is bounded and ``leaked_rows() == 0`` (every allocated row is
      registered or retired) holds after every epoch.

    Single writer: concurrent finishes contend through :meth:`try_acquire`;
    the loser takes the classic finish for that block.
    """

    def __init__(self, max_rows: int = 1 << 20, max_epoch_age: int = 64):
        self.max_rows = max(1024, int(max_rows))
        self.max_epoch_age = max(1, int(max_epoch_age))
        self.engine: SubtrieFusedEngine | None = None
        self.epoch = 0
        self.next_slot = 1  # slot 0 = the engines' dummy slot
        self._slot_of: dict[bytes, tuple[int, int]] = {}
        self.retired = 0
        self._commit_lock = threading.Lock()
        # counters (mirrored into the hotstate_* metrics by the committer)
        self.resident_hits = 0
        self.lookup_misses = 0
        self.evictions = 0
        self.faults = 0
        self.delta_epochs = 0
        self.full_epochs = 0
        self.contended = 0

    @classmethod
    def from_env(cls, env=None) -> "DigestArena":
        env = os.environ if env is None else env
        return cls(max_rows=int(env.get("RETH_TPU_HOT_ARENA_ROWS", "0") or (1 << 20)),
                   max_epoch_age=int(env.get("RETH_TPU_HOT_ARENA_EPOCHS", "0") or 64))

    # -- single writer --------------------------------------------------------

    def try_acquire(self) -> bool:
        if self._commit_lock.acquire(blocking=False):
            return True
        self.contended += 1
        return False

    def release(self) -> None:
        self._commit_lock.release()

    # -- epochs ---------------------------------------------------------------

    def begin_epoch(self, evict_storm: bool = False) -> bool:
        """Open a commit epoch; True: the arena is empty and this epoch is a
        full upload (``engine.begin``), False: a delta."""
        self.epoch += 1
        if evict_storm:
            self.evict("evict_storm")
        elif self.next_slot >= self.max_rows:
            self.evict("max_rows")
        fresh = self.next_slot == 1 or self.engine is None
        if fresh:
            self.full_epochs += 1
        else:
            self.delta_epochs += 1
        return fresh

    def evict(self, reason: str = "") -> None:
        """Drop the engine (and its buffer on the card) and forget every
        registered row; the next epoch is a full upload."""
        self.engine = None
        self._slot_of.clear()
        self.next_slot = 1
        self.retired = 0
        self.evictions += 1
        if reason:
            tracing.fault_event("hotstate_arena_evict", target="ops::fused_commit",
                                reason=reason, epoch=self.epoch)

    def invalidate(self, reason: str = "") -> None:
        """Wholesale invalidation from the tree (a deep reorg): waits out
        any commit in flight, then evicts."""
        with self._commit_lock:
            self.evict(reason)

    def on_fault(self, err: BaseException) -> None:
        """An epoch died in flight (a device fault, ``ArenaFault``, any
        exception of the committer's arena finish): count it and evict; the
        caller reruns the same commit on the classic finish, or raises a
        kernel fault (``_build.is_kernel_fault``)."""
        self.faults += 1
        fused_metrics.record_fallback()
        tracing.fault_event("hotstate_arena_fault", target="ops::fused_commit",
                            error=f"{type(err).__name__}: {err}"[:200], epoch=self.epoch)
        self.evict("fault")

    # -- rows -----------------------------------------------------------------

    def alloc(self) -> int:
        slot = self.next_slot
        self.next_slot += 1
        return slot

    def lookup(self, digest: bytes) -> int:
        """Resident slot of ``digest`` (0: not resident). Rows idle for
        ``max_epoch_age`` epochs retire here; a hit refreshes the tag."""
        ent = self._slot_of.get(digest)
        if ent is None:
            self.lookup_misses += 1
            return 0
        slot, last = ent
        if self.epoch - last > self.max_epoch_age:
            del self._slot_of[digest]
            self.retired += 1
            self.lookup_misses += 1
            return 0
        self._slot_of[digest] = (slot, self.epoch)
        self.resident_hits += 1
        return slot

    def note(self, digest: bytes, slot: int) -> None:
        """Register a row this epoch hashed; a digest already registered at
        another slot retires that slot."""
        old = self._slot_of.get(digest)
        if old is not None and old[0] != slot:
            self.retired += 1
        self._slot_of[digest] = (slot, self.epoch)

    def leaked_rows(self) -> int:
        """Allocated rows neither registered nor retired; 0 is an
        invariant."""
        return self.next_slot - 1 - len(self._slot_of) - self.retired

    def snapshot(self) -> dict:
        return {"epoch": self.epoch, "resident_rows": len(self._slot_of),
                "next_slot": self.next_slot, "retired": self.retired,
                "leaked_rows": self.leaked_rows(), "resident_hits": self.resident_hits,
                "lookup_misses": self.lookup_misses, "evictions": self.evictions,
                "faults": self.faults, "delta_epochs": self.delta_epochs,
                "full_epochs": self.full_epochs, "contended": self.contended}
