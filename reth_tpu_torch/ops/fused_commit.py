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
  ``trie/committer.py`` — PyTorch indexing around kernel 1 (the reference's
  ``_plain_level``/``_splice_level`` XLA programs).

The reference pads every dispatch to batch/hole tiers (junk rows and holes
aimed at slot 0) so XLA compiles a bounded set of shapes, and splits levels
at row caps for its int32 indices. Neither applies here: each launch takes
the exact row count and 64-bit indices, so there is no padding to land
anywhere and no split.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve, stream_handle
from ..primitives.keccak import RATE
from . import _build
from .keccak import _next_tier, keccak256_words_masked, keccak256_words_masked_ref


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


# -- kernel 2: one level of PACKED rows ---------------------------------------


def packed_level_ref(flat, row_off, row_len, slots, hole_start, hole_off, hole_src, buf):
    """Plain PyTorch version of kernel 2 (the reference's ``_packed_level``):
    gather rows, XOR keccak padding, splice child digests, hash, scatter
    into ``buf`` in place."""
    counts = (row_len // RATE + 1).to(torch.int32)
    L = int(counts.max()) * RATE
    col = torch.arange(L, device=buf.device)[None, :]
    idx = (row_off[:, None] + col).clamp(max=max(flat.shape[0] - 1, 0))
    rows = torch.where(col < row_len[:, None], flat[idx], 0).to(torch.uint8)
    rows ^= (col == row_len[:, None]).to(torch.uint8)
    rows ^= (col == (counts.long() * RATE - 1)[:, None]).to(torch.uint8) * 0x80
    if hole_off.shape[0]:
        hole_row = _csr_rows(hole_start)
        sidx = (hole_row * L + hole_off)[:, None] + torch.arange(32, device=buf.device)
        rows.view(-1)[sidx.reshape(-1)] = buf[hole_src].reshape(-1)
    d = keccak256_words_masked_ref(_bytes_to_words(rows), counts)
    buf[slots] = _digests_to_bytes(d)


def _fused_lib() -> ctypes.CDLL:
    lib = _build.load_kernel("fused_level.cu")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.packed_level.restype = ctypes.c_int
    lib.packed_level.argtypes = [p, i64, p, p, p, p, p, p, p, i64, p]
    lib.branch_level.restype = ctypes.c_int
    lib.branch_level.argtypes = [p, p, p, p, p, p, i64, p]
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
    each row's first hole (holes sorted by row); ``hole_off`` i32 /
    ``hole_src`` i64: the hole's byte offset in its row and the buffer slot
    of the digest spliced there. ``buf``: (S, 32) u8, updated in place."""
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
    if ch_nib.shape[0]:
        ch_row = _csr_rows(ch_start)
        off = hl[ch_row] + csum[ch_row, ch_nib.long()] + 1
        sidx = (ch_row * L + off)[:, None] + torch.arange(32, device=dev)
        flat[sidx.reshape(-1)] = buf[ch_src].reshape(-1)
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


# -- template levels (TrieCommitter's bucket protocol) -------------------------


def splice_level(templates, counts, hole_row, hole_off, hole_src, slots, buf):
    """The reference's ``_plain_level``/``_splice_level``: splice child
    digests into padded RLP templates (PyTorch indexing), hash them with
    kernel 1, scatter the digests into ``buf`` in place."""
    if hole_row.shape[0]:
        L = templates.shape[1]
        sidx = (hole_row * L + hole_off)[:, None] + torch.arange(32, device=buf.device)
        templates.view(-1)[sidx.reshape(-1)] = buf[hole_src].reshape(-1)
    d = keccak256_words_masked(_bytes_to_words(templates), counts)
    buf[slots] = _digests_to_bytes(d)


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
    the rows asked for. Slot 0 is a reserved dummy."""

    def __init__(self, min_tier: int = 1024, device: str | torch.device = "cuda"):
        self.min_tier = min_tier
        self.device = resolve(device)
        self._buf: torch.Tensor | None = None
        self._n_slots = 0

    # -- lifecycle ---------------------------------------------------------

    def begin(self, max_slots: int) -> None:
        s_tier = _next_tier(max_slots + 1, max(self.min_tier, 2))
        self._buf = torch.zeros((s_tier, 32), dtype=torch.uint8, device=self.device)
        self._n_slots = 1  # slot 0 = dummy

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
        grown = torch.zeros((_next_tier(need, max(self.min_tier, 2, cur)), 32),
                            dtype=torch.uint8, device=self.device)
        if cur:
            grown[:cur] = self._buf
        self._buf = grown

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

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on this engine's device, 16-byte aligned as the level
        kernels need (on the CPU a numpy view may start anywhere)."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return t if t.data_ptr() % 16 == 0 else t.clone()

    # -- dispatch ----------------------------------------------------------

    def dispatch_level(self, bucket: _Bucket) -> None:
        """One level bucket of RLP templates (TrieCommitter's fused path)."""
        n = len(bucket.templates)
        if n == 0:
            return
        L = _next_tier(bucket.nb_max, 2) * RATE
        templates = np.zeros((n, L), dtype=np.uint8)
        for i, t in enumerate(bucket.templates):
            tl = len(t)
            templates[i, :tl] = np.frombuffer(t, dtype=np.uint8)
            # keccak multi-rate padding at the message's own final block
            templates[i, tl] ^= 0x01
            templates[i, bucket.counts[i] * RATE - 1] ^= 0x80
        holes = np.asarray(bucket.holes, dtype=np.int64).reshape(-1, 3)
        splice_level(
            self._put(templates), self._put(np.asarray(bucket.counts, dtype=np.int32)),
            self._put(holes[:, 0]), self._put(holes[:, 1]), self._put(holes[:, 2]),
            self._put(np.asarray(bucket.slots, dtype=np.int64)), self._buf)

    def dispatch_packed(self, flat: np.ndarray, row_off: np.ndarray, row_len: np.ndarray,
                        slots: np.ndarray, holes: np.ndarray | None, b_tier: int) -> None:
        """One level of packed RLP rows from the native sweep. ``holes``:
        (3, H) int32 [row, byte_off, src_slot] or None. ``b_tier`` is part
        of the engine protocol; the kernel takes each row's own block
        count, so it is not needed here."""
        n = len(row_off)
        if n == 0:
            return
        if holes is None:
            holes = np.zeros((3, 0), dtype=np.int32)
        order, start = _csr(holes[0], n)
        packed_level(
            self._put(flat), self._put(row_off.astype(np.int64)),
            self._put(row_len.astype(np.int32)), self._put(slots.astype(np.int64)),
            self._put(start), self._put(holes[1][order].astype(np.int32)),
            self._put(holes[2][order].astype(np.int64)), self._buf)

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
