"""Static files: immutable columnar segment files for finalized history.

A copy of the JAX package's ``storage/static_files.py`` on the port's
NippyJar and provider.

Reference analogue: crates/static-file (`StaticFileProducer` moving
finalized headers/txs/receipts out of MDBX) + crates/storage/nippy-jar
(the immutable mmap column format with per-column compression tiers —
the reference offers zstd/lz4/uncompressed per jar). Format per file:

    magic "RTSF1\\n"
    u32 json_len | json header {segment, start, count, columns:[names],
                                compression:{col: none|zlib|lzma}}
    per column: u64[count+1] offsets | compressed rows back to back

Readers MEMORY-MAP the file (one mmap per immutable segment; row reads
are zero-copy slices + decompress). The compression tier is chosen per
column by sampling (like NippyJar's per-jar compressor selection):
incompressible rows (hashes) store raw, big repetitive rows take lzma,
the rest zlib. Files written before tiers existed (no "compression"
key) read back as all-zlib. The provider falls back to static files for
rows pruned from the DB, so history stays served after the producer runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from .nippyjar import NippyJar

SEGMENT_HEADERS = "headers"          # row key: block number; cols: header, hash
SEGMENT_TRANSACTIONS = "transactions"  # row key: tx number; cols: tx
SEGMENT_RECEIPTS = "receipts"        # row key: tx number; cols: receipt


def write_segment_file(
    path: Path, segment: str, start: int, columns: dict[str, list[bytes]],
    compression: str = "auto",
) -> None:
    """One segment = one NippyJar whose metadata carries the segment
    identity (the reference's static files are NippyJar + a config
    sidecar; here the jar's own metadata field serves that role)."""
    NippyJar.write(path, columns, metadata={"segment": segment,
                                            "start": start},
                   compression=compression)


@dataclass
class SegmentFile:
    """Segment view over a NippyJar: block/tx-number keyed row access."""

    path: Path
    segment: str
    start: int
    count: int
    columns: list[str]
    _jar: NippyJar

    @property
    def end(self) -> int:
        return self.start + self.count - 1

    @classmethod
    def open(cls, path: Path) -> "SegmentFile":
        jar = NippyJar.open(path)  # reads legacy RTSF1 files transparently
        meta = jar.metadata
        return cls(path, meta["segment"], meta["start"], jar.count,
                   jar.columns, jar)

    def row(self, number: int, column: str) -> bytes | None:
        if not (self.start <= number <= self.end):
            return None
        return self._jar.row(column, number - self.start)

    def close(self):
        self._jar.close()


class StaticFileProvider:
    """Read side over a directory of segment files."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._files: dict[str, list[SegmentFile]] = {}
        self.reload()

    def reload(self):
        for files in self._files.values():
            for sf in files:
                sf.close()
        self._files = {}
        for p in sorted(self.dir.glob("*.sf")):
            sf = SegmentFile.open(p)
            self._files.setdefault(sf.segment, []).append(sf)
        for files in self._files.values():
            files.sort(key=lambda s: s.start)

    def highest(self, segment: str) -> int | None:
        files = self._files.get(segment)
        return files[-1].end if files else None

    def row(self, segment: str, number: int, column: str) -> bytes | None:
        for sf in self._files.get(segment, []):
            if sf.start <= number <= sf.end:
                return sf.row(number, column)
        return None


class StaticFileProducer:
    """Moves finalized rows DB → segment files, then prunes the DB copies.

    Reference: static_file_producer.rs — runs after the pipeline commits;
    here it takes [from, to] block range per run.
    """

    def __init__(self, factory, provider_dir: str | Path):
        self.factory = factory
        self.static = StaticFileProvider(provider_dir)

    def run(self, to_block: int) -> dict[str, int]:
        """Copy segments up to ``to_block``; returns rows moved per segment."""
        from . import tables as T
        from .tables import Tables, be64

        moved = {}
        with self.factory.provider_rw() as p:
            h = self.static.highest(SEGMENT_HEADERS)
            start_block = (h if h is not None else -1) + 1
            if start_block > to_block:
                return {}
            headers, hashes, txs, receipts = [], [], [], []
            first_tx_num = None
            for n in range(start_block, to_block + 1):
                h = p.header_by_number(n)
                if h is None:
                    raise ValueError(f"missing header {n}")
                headers.append(h.encode())
                hashes.append(h.hash)
                idx = p.block_body_indices(n)
                if idx and idx.tx_count:
                    if first_tx_num is None:
                        first_tx_num = idx.first_tx_num
                    for t in range(idx.first_tx_num, idx.next_tx_num):
                        raw_tx = p.tx.get(Tables.Transactions.name, be64(t))
                        if raw_tx is None:
                            raise ValueError(f"missing tx {t} in block {n}")
                        txs.append(raw_tx)
                        raw_rc = p.tx.get(Tables.Receipts.name, be64(t))
                        receipts.append(raw_rc or b"")
            write_segment_file(
                self.static.dir / f"headers_{start_block}_{to_block}.sf",
                SEGMENT_HEADERS, start_block,
                {"header": headers, "hash": hashes},
            )
            moved[SEGMENT_HEADERS] = len(headers)
            if txs:
                write_segment_file(
                    self.static.dir / f"transactions_{first_tx_num}_{first_tx_num + len(txs) - 1}.sf",
                    SEGMENT_TRANSACTIONS, first_tx_num, {"tx": txs},
                )
                write_segment_file(
                    self.static.dir / f"receipts_{first_tx_num}_{first_tx_num + len(txs) - 1}.sf",
                    SEGMENT_RECEIPTS, first_tx_num, {"receipt": receipts},
                )
                moved[SEGMENT_TRANSACTIONS] = len(txs)
                moved[SEGMENT_RECEIPTS] = len(receipts)
            # prune DB copies (headers stay for canonical-hash lookups of
            # the recent window; here we drop tx/receipt rows like the
            # reference's static-file-backed tables)
            for n in range(start_block, to_block + 1):
                idx = p.block_body_indices(n)
                if idx and idx.tx_count:
                    for t in range(idx.first_tx_num, idx.next_tx_num):
                        p.tx.delete(Tables.Transactions.name, be64(t))
                        p.tx.delete(Tables.Receipts.name, be64(t))
        self.static.reload()
        return moved
