"""Snappy raw-block codec (pure Python) for RLPx message compression.

Reference analogue: the `snap` crate behind reth's eth-wire multiplexing
(RLPx requires snappy for p2p protocol v5+). Decompression implements the
full raw format (literals + all three copy element kinds); compression
uses the standard greedy hash-table matcher, and any output we produce is
decodable by every conformant snappy implementation.

Format (raw block, not framed): uvarint total length, then elements with
a 2-bit tag: 00 literal, 01 copy (len 4-11, offset 11 bits),
10 copy (len 1-64, offset 16 bits LE), 11 copy (offset 32 bits LE).
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def _uvarint(data: bytes, i: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(data):
            raise SnappyError("truncated uvarint")
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise SnappyError("uvarint too long")


def _put_uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decompress(data: bytes, max_len: int = 16 * 1024 * 1024) -> bytes:
    total, i = _uvarint(data, 0)
    if total > max_len:
        raise SnappyError(f"declared length {total} over limit")
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        kind = tag & 3
        i += 1
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if i + extra > n:
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(data[i : i + extra], "little")
                i += extra
            ln += 1
            if i + ln > n:
                raise SnappyError("truncated literal")
            out += data[i : i + ln]
            i += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8)
            if i >= n:
                raise SnappyError("truncated copy1")
            off |= data[i]
            i += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            if i + 2 > n:
                raise SnappyError("truncated copy2")
            off = int.from_bytes(data[i : i + 2], "little")
            i += 2
        else:
            ln = (tag >> 2) + 1
            if i + 4 > n:
                raise SnappyError("truncated copy4")
            off = int.from_bytes(data[i : i + 4], "little")
            i += 4
        if off == 0 or off > len(out):
            raise SnappyError("copy offset out of range")
        for _ in range(ln):  # overlapping copies are allowed
            out.append(out[-off])
        if len(out) > max_len:
            raise SnappyError("decompressed over limit")
    if len(out) != total:
        raise SnappyError(f"length mismatch: {len(out)} != declared {total}")
    return bytes(out)


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += chunk


def compress(data: bytes) -> bytes:
    """Greedy hash-table matcher (4-byte anchors, 64KB window)."""
    out = bytearray(_put_uvarint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        key = data[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand : cand + 4] == key:
            # extend the match
            ln = 4
            while i + ln < n and ln < 64 and data[cand + ln] == data[i + ln]:
                ln += 1
            if lit_start < i:
                _emit_literal(out, data[lit_start:i])
            off = i - cand
            if 4 <= ln <= 11 and off < (1 << 11):
                out.append(1 | ((ln - 4) << 2) | ((off >> 8) << 5))
                out.append(off & 0xFF)
            else:
                out.append(2 | ((ln - 1) << 2))
                out += off.to_bytes(2, "little")
            i += ln
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)
