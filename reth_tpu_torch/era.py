"""Era1 history archives: e2store container + framed-snappy records.

Reference analogue: crates/era (e2store read/write, era1 groups) +
era-utils import/export (reference crates/era/src/lib.rs:1-12). An era1
file holds a contiguous pre-merge-style block range:

  Version | {CompressedHeader CompressedBody CompressedReceipts
  TotalDifficulty}xN | Accumulator | BlockIndex

e2store record: 2-byte LE type | 4-byte LE length | 2 reserved zero
bytes | payload. Compressed records use the SNAPPY FRAMED format
(stream identifier + compressed/uncompressed chunks with masked CRC32C),
wrapping this repo's raw-snappy codec (net/snappy.py).

A copy of the JAX package's module: era1 files written by either package
are byte-identical, and each reads the other's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .net import snappy
from .primitives.rlp import rlp_encode
from .primitives.types import Block, Header

# e2store record types (era1)
TYPE_VERSION = 0x3265
TYPE_COMPRESSED_HEADER = 0x03
TYPE_COMPRESSED_BODY = 0x04
TYPE_COMPRESSED_RECEIPTS = 0x05
TYPE_TOTAL_DIFFICULTY = 0x06
TYPE_ACCUMULATOR = 0x07
TYPE_BLOCK_INDEX = 0x3266

MAX_ERA1_SIZE = 8192  # blocks per era1 file


class EraError(ValueError):
    pass


# -- CRC32C (Castagnoli) -----------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- snappy framed format ----------------------------------------------------

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"


def snappy_frame_compress(data: bytes) -> bytes:
    out = bytearray(_STREAM_ID)
    # one chunk per 64 KiB of input (framed-format chunk limit)
    for off in range(0, max(len(data), 1), 65536):
        chunk = data[off : off + 65536]
        comp = snappy.compress(chunk)
        if len(comp) < len(chunk):
            body = struct.pack("<I", _masked_crc(chunk)) + comp
            out += b"\x00" + struct.pack("<I", len(body))[:3] + body
        else:
            body = struct.pack("<I", _masked_crc(chunk)) + chunk
            out += b"\x01" + struct.pack("<I", len(body))[:3] + body
    return bytes(out)


def snappy_frame_decompress(data: bytes) -> bytes:
    if not data.startswith(_STREAM_ID):
        raise EraError("missing snappy stream identifier")
    out = bytearray()
    i = len(_STREAM_ID)
    while i < len(data):
        if i + 4 > len(data):
            raise EraError("truncated frame header")
        kind = data[i]
        ln = int.from_bytes(data[i + 1 : i + 4], "little")
        i += 4
        body = data[i : i + ln]
        if len(body) != ln:
            raise EraError("truncated frame body")
        i += ln
        if kind in (0x00, 0x01):
            if len(body) < 4:
                raise EraError("chunk shorter than its checksum")
            want_crc = struct.unpack("<I", body[:4])[0]
            payload = body[4:]
            try:
                chunk = snappy.decompress(payload) if kind == 0x00 else payload
            except snappy.SnappyError as e:
                raise EraError(f"bad snappy chunk: {e}") from e
            if _masked_crc(chunk) != want_crc:
                raise EraError("frame checksum mismatch")
            out += chunk
        elif 0x80 <= kind <= 0xFE:  # skippable incl. 0xFE padding
            continue  # skippable
        else:
            raise EraError(f"unknown frame chunk type {kind:#x}")
    return bytes(out)


# -- e2store ------------------------------------------------------------------


def write_record(out, rtype: int, payload: bytes) -> None:
    out.write(struct.pack("<HI", rtype, len(payload)) + b"\x00\x00")
    out.write(payload)


def read_records(data: bytes):
    """Yield (type, payload) for every record in the buffer."""
    i = 0
    while i < len(data):
        if i + 8 > len(data):
            raise EraError("truncated e2store header")
        rtype, ln = struct.unpack_from("<HI", data, i)
        if data[i + 6 : i + 8] != b"\x00\x00":
            raise EraError("nonzero reserved bytes")
        i += 8
        payload = data[i : i + ln]
        if len(payload) != ln:
            raise EraError("truncated e2store payload")
        i += ln
        yield rtype, payload


# -- era1 groups --------------------------------------------------------------


@dataclass
class Era1Group:
    """One era1 file's content: blocks + per-block receipts + TDs."""

    start_block: int
    blocks: list[Block]
    receipts: list[list[bytes]]          # encoded receipts per block
    total_difficulties: list[int]


def write_era1(path, group: Era1Group) -> None:
    from .primitives.types import body_rlp_fields

    if len(group.blocks) > MAX_ERA1_SIZE:
        raise EraError(f"era1 holds at most {MAX_ERA1_SIZE} blocks")
    offsets: list[int] = []
    with open(path, "wb") as f:
        write_record(f, TYPE_VERSION, b"")
        for blk, rcpts, td in zip(group.blocks, group.receipts,
                                  group.total_difficulties):
            offsets.append(f.tell())
            write_record(f, TYPE_COMPRESSED_HEADER,
                         snappy_frame_compress(blk.header.encode()))
            body = rlp_encode(body_rlp_fields(blk.transactions, blk.ommers,
                                              blk.withdrawals))
            write_record(f, TYPE_COMPRESSED_BODY, snappy_frame_compress(body))
            write_record(f, TYPE_COMPRESSED_RECEIPTS,
                         snappy_frame_compress(rlp_encode(list(rcpts))))
            write_record(f, TYPE_TOTAL_DIFFICULTY, td.to_bytes(32, "little"))
        write_record(f, TYPE_ACCUMULATOR, b"\x00" * 32)  # post-merge: unused
        index_pos = f.tell()
        n = len(group.blocks)
        index = struct.pack("<q", group.start_block)
        # relative offsets from the BlockIndex record start (era1 spec shape)
        index += b"".join(struct.pack("<q", off - index_pos) for off in offsets)
        index += struct.pack("<q", n)
        write_record(f, TYPE_BLOCK_INDEX, index)


def read_era1(path) -> Era1Group:
    from .primitives.types import body_from_fields
    from .primitives.rlp import rlp_decode

    with open(path, "rb") as f:
        data = f.read()
    records = list(read_records(data))
    if not records or records[0][0] != TYPE_VERSION:
        raise EraError("missing version record")
    start_block = None
    blocks: list[Block] = []
    receipts: list[list[bytes]] = []
    tds: list[int] = []
    header = None
    body = None
    rcpts = None
    for rtype, payload in records:
        if rtype == TYPE_COMPRESSED_HEADER:
            header = Header.decode(snappy_frame_decompress(payload))
        elif rtype == TYPE_COMPRESSED_BODY:
            body = snappy_frame_decompress(payload)
        elif rtype == TYPE_COMPRESSED_RECEIPTS:
            rcpts = rlp_decode(snappy_frame_decompress(payload))
        elif rtype == TYPE_TOTAL_DIFFICULTY:
            if header is None or body is None:
                raise EraError("total-difficulty before header/body")
            txs, ommers, withdrawals = body_from_fields(rlp_decode(body))
            blocks.append(Block(header, txs, ommers, withdrawals))
            receipts.append(list(rcpts or []))
            tds.append(int.from_bytes(payload, "little"))
            header = body = rcpts = None
        elif rtype == TYPE_BLOCK_INDEX:
            start_block = struct.unpack_from("<q", payload, 0)[0]
    if start_block is None:
        raise EraError("missing block index")
    if blocks and blocks[0].header.number != start_block:
        raise EraError("block index start mismatch")
    return Era1Group(start_block, blocks, receipts, tds)


# -- import/export over the provider -----------------------------------------


def export_era(factory, first: int, last: int, path) -> int:
    """Era1 file from the canonical chain [first, last] (reference
    export-era); returns the block count."""
    with factory.provider() as p:
        blocks = []
        receipts = []
        tds = []
        for n in range(first, last + 1):
            blk = p.block_by_number(n)
            if blk is None:
                raise EraError(f"missing canonical block {n}")
            blocks.append(blk)
            idx = p.block_body_indices(n)
            rc = []
            for t in range(idx.first_tx_num, idx.first_tx_num + idx.tx_count):
                r = p.receipt(t)
                if r is None:
                    raise EraError(
                        f"missing receipt for tx {t} of block {n} "
                        "(pruned? export a retained range)"
                    )
                rc.append(r.encode_2718())
            receipts.append(rc)
            tds.append(0)  # post-merge difficulty is zero
    write_era1(path, Era1Group(first, blocks, receipts, tds))
    return len(blocks)


def import_era(factory, path, consensus=None) -> int:
    """Append an era1 file's blocks to the chain (reference import-era);
    returns the new tip. The pipeline derives the rest (receipts are
    re-derived by execution — the era receipts serve verification)."""
    from .storage.genesis import import_chain

    group = read_era1(path)
    return import_chain(factory, group.blocks, consensus)
