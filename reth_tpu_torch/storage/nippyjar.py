"""NippyJar: the standalone immutable mmap column-file format.

A copy of the JAX package's ``storage/nippyjar.py``: the same bytes for the
same columns, so a jar written by either package opens in the other.

Reference analogue: crates/storage/nippy-jar (`NippyJar`,
nippy-jar/src/lib.rs:1-30) — an immutable, memory-mapped columnar file
with a per-column compression tier, an offsets table per column, and a
data-integrity check. Static files build ON this format
(`storage/static_files.py` wraps a jar with segment/start semantics),
but the jar itself is general: any (columns -> rows of bytes) dataset
with arbitrary user metadata.

Wire format:

    magic "RTNJ1\\n"
    u32 header_len | json header {columns:[names], count,
                                  compression:{col: none|zlib|lzma},
                                  meta:{...user metadata...},
                                  data_sha256: hex}
    per column: u64[count+1] offsets | compressed rows back to back

``data_sha256`` covers everything after the header — :meth:`verify`
detects bit rot / truncation without reading rows through codecs.
Files written by the pre-extraction static-file writer (magic "RTSF1\\n",
segment keys at the top level, no integrity hash) open transparently.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import mmap
import struct
import zlib
from pathlib import Path

MAGIC = b"RTNJ1\n"
LEGACY_MAGIC = b"RTSF1\n"  # pre-extraction static-file format

CODECS = {
    "none": (lambda b: b, lambda b: b),
    "zlib": (zlib.compress, zlib.decompress),
    "lzma": (lambda b: lzma.compress(b, preset=6), lzma.decompress),
}


def pick_codec(rows: list[bytes]) -> str:
    """Sample-driven tier choice (the reference picks a compressor per
    jar by sampling): smallest total wins, with 'none' preferred unless
    compression actually pays >10%."""
    sample = [r for r in rows[:16] if r]
    if not sample:
        return "none"
    raw = sum(len(r) for r in sample)
    z = sum(len(zlib.compress(r)) for r in sample)
    best, best_size = "none", raw
    if z < raw * 0.9:
        best, best_size = "zlib", z
    # lzma only worth trying on bigger rows (its header alone is ~60 B)
    if raw / len(sample) >= 256:
        xz = sum(len(lzma.compress(r, preset=6)) for r in sample)
        if xz < best_size * 0.9:
            best = "lzma"
    return best


class NippyJar:
    """An open (immutable, mmapped) jar."""

    def __init__(self, path: Path, columns: list[str], count: int,
                 codecs: dict[str, str], metadata: dict,
                 col_offsets: dict[str, int], data_sha256: str | None,
                 fh, mm):
        self.path = path
        self.columns = columns
        self.count = count
        self.metadata = metadata
        self._codecs = codecs
        self._col_offsets = col_offsets  # file offset of each offset table
        self._data_sha256 = data_sha256
        self._fh = fh
        self._map = mm

    # -- writing --------------------------------------------------------------

    @staticmethod
    def write(path: str | Path, columns: dict[str, list[bytes]],
              metadata: dict | None = None,
              compression: str = "auto") -> None:
        """Create a jar at ``path``. ``compression`` is a codec name or
        "auto" (per-column sampling)."""
        path = Path(path)
        names = list(columns.keys())
        count = len(next(iter(columns.values()))) if names else 0
        for rows in columns.values():
            assert len(rows) == count, "ragged columns"
        codecs = {
            name: (pick_codec(columns[name]) if compression == "auto"
                   else compression)
            for name in names
        }
        data = bytearray()
        for name in names:
            enc = CODECS[codecs[name]][0]
            blobs = [enc(r) for r in columns[name]]
            offsets = [0]
            for b in blobs:
                offsets.append(offsets[-1] + len(b))
            data += struct.pack(f"<{count + 1}Q", *offsets)
            for b in blobs:
                data += b
        header = json.dumps({
            "columns": names, "count": count, "compression": codecs,
            "meta": metadata or {},
            "data_sha256": hashlib.sha256(bytes(data)).hexdigest(),
        }).encode()
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(bytes(data))
            # durability before visibility: fsync the bytes, rename, then
            # fsync the directory — a crash right after replace() must
            # never surface a jar whose data did not reach the platter
            f.flush()
            try:
                import os

                os.fsync(f.fileno())
            except OSError:  # pragma: no cover - platform-dependent
                pass
        from ..chaos import crash_point

        crash_point("jar-rename")
        tmp.replace(path)  # jars appear atomically (immutable once named)
        from .wal import fsync_dir

        fsync_dir(path.parent)

    # -- reading --------------------------------------------------------------

    @classmethod
    def open(cls, path: str | Path) -> "NippyJar":
        path = Path(path)
        f = open(path, "rb")
        magic = f.read(6)
        if magic not in (MAGIC, LEGACY_MAGIC):
            f.close()
            raise ValueError(f"{path}: bad magic {magic!r}")
        (hlen,) = struct.unpack("<I", f.read(4))
        hdr = json.loads(f.read(hlen))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        pos = 6 + 4 + hlen
        col_offsets = {}
        for name in hdr["columns"]:
            col_offsets[name] = pos
            (last,) = struct.unpack_from("<Q", mm, pos + 8 * hdr["count"])
            pos += 8 * (hdr["count"] + 1) + last
        # legacy static files: segment keys at top level, all-zlib default
        codecs = hdr.get("compression") or {n: "zlib" for n in hdr["columns"]}
        meta = hdr.get("meta")
        if meta is None:
            meta = {k: v for k, v in hdr.items()
                    if k not in ("columns", "count", "compression")}
        return cls(path, hdr["columns"], hdr["count"], codecs, meta,
                   col_offsets, hdr.get("data_sha256"), f, mm)

    def row(self, column: str, i: int) -> bytes:
        if not (0 <= i < self.count):
            raise IndexError(f"row {i} outside [0, {self.count})")
        base = self._col_offsets[column]
        m = self._map  # immutable file: zero-copy mmap slices
        lo, hi = struct.unpack_from("<2Q", m, base + 8 * i)
        payload_base = base + 8 * (self.count + 1)
        raw = m[payload_base + lo:payload_base + hi]
        return CODECS[self._codecs[column]][1](raw)

    def column_rows(self, column: str):
        """Iterate a whole column (decompressed)."""
        for i in range(self.count):
            yield self.row(column, i)

    def verify(self) -> bool:
        """Data-section integrity against the stored sha256 (legacy files
        carry none and verify trivially True)."""
        if self._data_sha256 is None:
            return True
        start = min(self._col_offsets.values()) if self._col_offsets else \
            len(self._map)
        return (hashlib.sha256(self._map[start:]).hexdigest()
                == self._data_sha256)

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        if self._fh:
            self._fh.close()
            self._fh = None
