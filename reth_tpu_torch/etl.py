"""ETL external-sort collector: buffer -> sorted spill files -> k-way merge.

A copy of the JAX package's ``etl.py``. Reference analogue: `Collector<K, V>`
(crates/etl/src/lib.rs:31-40) — bulk loads into sorted tables (hashed state,
tx hashes) buffer here first, spill sorted runs to disk when the memory
budget is hit, and stream back in globally sorted order via a heap merge.
Keeps bulk-load memory bounded regardless of input size, and makes the final
table inserts append-ordered (cheap for any B+tree-ish store).
"""

from __future__ import annotations

import heapq
import struct
import tempfile
from typing import Iterator


class Collector:
    """Collects (key, value) byte pairs; iterates them in sorted order.

    Duplicate keys are preserved in insertion order (stable merge) — the
    caller decides last-wins or error semantics. Use as a context manager
    or call ``close()`` to drop spill files."""

    def __init__(self, buffer_bytes: int = 64 * 1024 * 1024, tmp_dir: str | None = None):
        self.buffer_bytes = buffer_bytes
        self.tmp_dir = tmp_dir
        self._buf: list[tuple[bytes, int, bytes]] = []  # (key, seq, value)
        self._buf_size = 0
        self._files: list = []
        self._seq = 0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def insert(self, key: bytes, value: bytes) -> None:
        self._buf.append((key, self._seq, value))
        self._seq += 1
        self._len += 1
        self._buf_size += len(key) + len(value) + 16
        if self._buf_size >= self.buffer_bytes:
            self._spill()

    def _spill(self) -> None:
        if not self._buf:
            return
        self._buf.sort()
        f = tempfile.TemporaryFile(dir=self.tmp_dir, prefix="reth-tpu-etl-")
        w = f.write
        for key, seq, value in self._buf:
            w(struct.pack("<IQI", len(key), seq, len(value)))
            w(key)
            w(value)
        f.flush()
        f.seek(0)
        self._files.append(f)
        self._buf = []
        self._buf_size = 0

    @staticmethod
    def _read_run(f) -> Iterator[tuple[bytes, int, bytes]]:
        header = struct.Struct("<IQI")
        while True:
            raw = f.read(header.size)
            if not raw:
                return
            klen, seq, vlen = header.unpack(raw)
            key = f.read(klen)
            value = f.read(vlen)
            yield (key, seq, value)

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        """Globally sorted (key, value) stream across buffer + spills."""
        self._buf.sort()
        runs: list = [iter(self._buf)]
        for f in self._files:
            f.seek(0)
            runs.append(self._read_run(f))
        for key, _seq, value in heapq.merge(*runs):
            yield key, value

    def close(self) -> None:
        for f in self._files:
            f.close()
        self._files = []
        self._buf = []
        self._buf_size = 0
        self._len = 0

    def __enter__(self) -> "Collector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
