"""Keccak-256 — CPU reference implementations (a copy of the JAX package's
``primitives/keccak.py``, with the pure-Python permutation unrolled; the
port imports nothing of that package).

Ethereum's Keccak-256 (original Keccak padding 0x01, NOT NIST SHA3's 0x06):

- ``keccak256``          — pure-Python, bit-exact reference.
- ``Keccak256``          — the same, incremental (the RLPx frame MACs).
- ``keccak256_batch_np`` — numpy-vectorised batch version over uint64 lanes.
- ``keccak256_words_np`` / ``keccak256_words_masked_np`` — the numpy twins
  of the device absorb over pre-padded words (``trie/turbo.py``'s numpy
  backend hashes through them).

The permutation layout follows FIPS-202: 25 lanes of 64 bits, flat index
``idx = x + 5*y``.
"""

from __future__ import annotations

import numpy as np

RATE = 136  # bytes: keccak-256 rate (1088 bits), capacity 512

# Round constants for keccak-f[1600] (24 rounds).
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y].
ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def keccak_f1600(state: list[int]) -> list[int]:
    """One keccak-f[1600] permutation over 25 python-int lanes (pure ref).
    Each round is written out lane by lane (theta; rho and pi into b; chi;
    iota) rather than as loops over lists: the host validates nodes one at
    a time with it (``keccak256``), on the hot-state plane's reveal and
    cache paths."""
    (a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11, a12,
     a13, a14, a15, a16, a17, a18, a19, a20, a21, a22, a23, a24) = state
    m = _MASK
    for rc in RC:
        c0 = a0 ^ a5 ^ a10 ^ a15 ^ a20
        c1 = a1 ^ a6 ^ a11 ^ a16 ^ a21
        c2 = a2 ^ a7 ^ a12 ^ a17 ^ a22
        c3 = a3 ^ a8 ^ a13 ^ a18 ^ a23
        c4 = a4 ^ a9 ^ a14 ^ a19 ^ a24
        d0 = c4 ^ (((c1 << 1) | (c1 >> 63)) & m)
        d1 = c0 ^ (((c2 << 1) | (c2 >> 63)) & m)
        d2 = c1 ^ (((c3 << 1) | (c3 >> 63)) & m)
        d3 = c2 ^ (((c4 << 1) | (c4 >> 63)) & m)
        d4 = c3 ^ (((c0 << 1) | (c0 >> 63)) & m)
        b0 = a0 ^ d0
        t = a5 ^ d0
        b16 = ((t << 36) | (t >> 28)) & m
        t = a10 ^ d0
        b7 = ((t << 3) | (t >> 61)) & m
        t = a15 ^ d0
        b23 = ((t << 41) | (t >> 23)) & m
        t = a20 ^ d0
        b14 = ((t << 18) | (t >> 46)) & m
        t = a1 ^ d1
        b10 = ((t << 1) | (t >> 63)) & m
        t = a6 ^ d1
        b1 = ((t << 44) | (t >> 20)) & m
        t = a11 ^ d1
        b17 = ((t << 10) | (t >> 54)) & m
        t = a16 ^ d1
        b8 = ((t << 45) | (t >> 19)) & m
        t = a21 ^ d1
        b24 = ((t << 2) | (t >> 62)) & m
        t = a2 ^ d2
        b20 = ((t << 62) | (t >> 2)) & m
        t = a7 ^ d2
        b11 = ((t << 6) | (t >> 58)) & m
        t = a12 ^ d2
        b2 = ((t << 43) | (t >> 21)) & m
        t = a17 ^ d2
        b18 = ((t << 15) | (t >> 49)) & m
        t = a22 ^ d2
        b9 = ((t << 61) | (t >> 3)) & m
        t = a3 ^ d3
        b5 = ((t << 28) | (t >> 36)) & m
        t = a8 ^ d3
        b21 = ((t << 55) | (t >> 9)) & m
        t = a13 ^ d3
        b12 = ((t << 25) | (t >> 39)) & m
        t = a18 ^ d3
        b3 = ((t << 21) | (t >> 43)) & m
        t = a23 ^ d3
        b19 = ((t << 56) | (t >> 8)) & m
        t = a4 ^ d4
        b15 = ((t << 27) | (t >> 37)) & m
        t = a9 ^ d4
        b6 = ((t << 20) | (t >> 44)) & m
        t = a14 ^ d4
        b22 = ((t << 39) | (t >> 25)) & m
        t = a19 ^ d4
        b13 = ((t << 8) | (t >> 56)) & m
        t = a24 ^ d4
        b4 = ((t << 14) | (t >> 50)) & m
        a0 = b0 ^ (~b1 & b2)
        a1 = b1 ^ (~b2 & b3)
        a2 = b2 ^ (~b3 & b4)
        a3 = b3 ^ (~b4 & b0)
        a4 = b4 ^ (~b0 & b1)
        a5 = b5 ^ (~b6 & b7)
        a6 = b6 ^ (~b7 & b8)
        a7 = b7 ^ (~b8 & b9)
        a8 = b8 ^ (~b9 & b5)
        a9 = b9 ^ (~b5 & b6)
        a10 = b10 ^ (~b11 & b12)
        a11 = b11 ^ (~b12 & b13)
        a12 = b12 ^ (~b13 & b14)
        a13 = b13 ^ (~b14 & b10)
        a14 = b14 ^ (~b10 & b11)
        a15 = b15 ^ (~b16 & b17)
        a16 = b16 ^ (~b17 & b18)
        a17 = b17 ^ (~b18 & b19)
        a18 = b18 ^ (~b19 & b15)
        a19 = b19 ^ (~b15 & b16)
        a20 = b20 ^ (~b21 & b22)
        a21 = b21 ^ (~b22 & b23)
        a22 = b22 ^ (~b23 & b24)
        a23 = b23 ^ (~b24 & b20)
        a24 = b24 ^ (~b20 & b21)
        a0 ^= rc
    return [a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11, a12,
            a13, a14, a15, a16, a17, a18, a19, a20, a21, a22, a23, a24]


def _pad(data: bytes) -> bytes:
    """Multi-rate keccak padding: 0x01 … 0x80 (0x81 if a single pad byte)."""
    q = RATE - (len(data) % RATE)
    if q == 1:
        return data + b"\x81"
    return data + b"\x01" + b"\x00" * (q - 2) + b"\x80"


def keccak256(data: bytes) -> bytes:
    """Ethereum Keccak-256 of ``data`` (pure-Python reference)."""
    padded = _pad(bytes(data))
    state = [0] * 25
    for off in range(0, len(padded), RATE):
        block = padded[off : off + RATE]
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


class Keccak256:
    """Incremental (streaming) keccak-256 with copyable state.

    The RLPx frame-MAC scheme (net/rlpx.py) keeps two forever-running
    keccak states (egress/ingress) and reads 16-byte digests mid-stream;
    ``digest()`` pads a COPY so the running state is unaffected."""

    def __init__(self, data: bytes = b""):
        self._state = [0] * 25
        self._buf = b""
        if data:
            self.update(data)

    def update(self, data: bytes) -> "Keccak256":
        buf = self._buf + bytes(data)
        off = 0
        while len(buf) - off >= RATE:
            block = buf[off : off + RATE]
            for i in range(RATE // 8):
                self._state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
            self._state = keccak_f1600(self._state)
            off += RATE
        self._buf = buf[off:]
        return self

    def copy(self) -> "Keccak256":
        k = Keccak256()
        k._state = list(self._state)
        k._buf = self._buf
        return k

    def digest(self) -> bytes:
        state = list(self._state)
        padded = _pad(self._buf)  # buffered remainder < RATE => one block
        for off in range(0, len(padded), RATE):
            blk = padded[off : off + RATE]
            for i in range(RATE // 8):
                state[i] ^= int.from_bytes(blk[8 * i : 8 * i + 8], "little")
            state = keccak_f1600(state)
        return b"".join(state[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------------
# numpy-vectorised batch implementation (CPU baseline)
# ---------------------------------------------------------------------------

_RC_NP = np.array(RC, dtype=np.uint64)


def _rotl_np(v: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def keccak_f1600_np(lanes: np.ndarray) -> np.ndarray:
    """Vectorised keccak-f[1600]: ``lanes`` is (N, 25) uint64."""
    a = [lanes[:, i].copy() for i in range(25)]
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl_np(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = a[x + 5 * y] ^ d[x]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl_np(a[x + 5 * y], ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
        a[0] = a[0] ^ _RC_NP[rnd]
    return np.stack(a, axis=1)


def pad_batch(
    msgs: list[bytes],
    num_blocks: int | np.ndarray,
    pad_to_blocks: int | None = None,
) -> np.ndarray:
    """Pad each message at ITS OWN final rate block, zero-extend the buffer to
    ``pad_to_blocks`` blocks; return (N, pad_to_blocks*17) uint64.

    ``num_blocks`` is each message's real block count (``num_blocks_for``) —
    a scalar for uniform buckets or a per-message array. ``pad_to_blocks``
    defaults to the max block count; blocks at index >= a message's count are
    all-zero and must NOT be absorbed (masked-absorb kernels only).
    """
    n = len(msgs)
    nb = np.broadcast_to(np.asarray(num_blocks, dtype=np.int64), (n,))
    total = (pad_to_blocks if pad_to_blocks is not None else int(nb.max() if n else 1)) * RATE
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    if lens.size and (lens > nb * RATE - 1).any():
        bad = int(np.argmax(lens > nb * RATE - 1))
        raise ValueError(f"message {bad} too long for {nb[bad]} blocks: {lens[bad]}")
    # Vectorised scatter: this runs on the host hot path feeding the device,
    # so no per-message Python work is allowed.
    flat = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(total, dtype=np.int64)
    gather = starts[:, None] + cols[None, :]
    valid = cols[None, :] < lens[:, None]
    np.minimum(gather, max(flat.size - 1, 0), out=gather)
    buf = np.where(valid, flat[gather] if flat.size else 0, 0).astype(np.uint8)
    rows = np.arange(n)
    buf[rows, lens] ^= 0x01
    buf[rows, nb * RATE - 1] ^= 0x80
    return buf.view("<u8").reshape(n, total // 8)


def num_blocks_for(msg: bytes) -> int:
    """Rate-block count of ``msg`` after keccak padding."""
    return len(msg) // RATE + 1


def bucketed_hash(msgs: list[bytes], bucket_hasher, bucket_key=None) -> list[bytes]:
    """Shared bucketing scaffolding for batch hashers.

    Messages are grouped by ``bucket_key(num_blocks)`` (default: the exact
    block count). ``bucket_hasher(sub_msgs, key, counts)`` — where ``counts``
    is the per-message real block-count array — must return an array whose
    rows view as the 32-byte digests (``row.tobytes()`` == digest). Order of
    ``msgs`` is preserved. Both the numpy CPU baseline and the device
    front-end route through this, so bucketing semantics cannot diverge.
    """
    if not msgs:
        return []
    out: list[bytes | None] = [None] * len(msgs)
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(msgs):
        nb = num_blocks_for(m)
        buckets.setdefault(bucket_key(nb) if bucket_key else nb, []).append(i)
    for key, idxs in sorted(buckets.items()):
        counts = np.fromiter(
            (num_blocks_for(msgs[i]) for i in idxs), dtype=np.int64, count=len(idxs)
        )
        digests = bucket_hasher([msgs[i] for i in idxs], key, counts)
        for row, i in enumerate(idxs):
            out[i] = digests[row].tobytes()
    return out  # type: ignore[return-value]


def keccak256_batch_np(msgs: list[bytes]) -> list[bytes]:
    """Batched keccak-256 over same-or-mixed-length messages (numpy, CPU)."""
    return bucketed_hash(
        msgs, lambda sub, nb, _counts: keccak256_words_np(pad_batch(sub, nb), nb)
    )


def keccak256_words_masked_np(
    words: np.ndarray, max_blocks: int, counts: np.ndarray
) -> np.ndarray:
    """Masked absorb (numpy twin of the device absorb): each message padded
    at its OWN final rate block and zero-extended to ``max_blocks``; blocks
    at index >= counts[i] leave message i's state untouched. Returns
    (N, 4) uint64 digest lanes."""
    n = words.shape[0]
    state = np.zeros((n, 25), dtype=np.uint64)
    for blk in range(max_blocks):
        nxt = state.copy()
        nxt[:, :17] ^= words[:, blk * 17 : (blk + 1) * 17]
        nxt = keccak_f1600_np(nxt)
        live = (blk < counts)[:, None]
        state = np.where(live, nxt, state)
    return np.ascontiguousarray(state[:, :4])


def keccak256_words_np(words: np.ndarray, num_blocks: int) -> np.ndarray:
    """Absorb ``num_blocks`` rate-blocks of pre-padded words, return (N, 4) u64.

    ``words`` is (N, num_blocks*17) uint64 little-endian as from ``pad_batch``.
    """
    n = words.shape[0]
    state = np.zeros((n, 25), dtype=np.uint64)
    for blk in range(num_blocks):
        state[:, :17] ^= words[:, blk * 17 : (blk + 1) * 17]
        state = keccak_f1600_np(state)
    return np.ascontiguousarray(state[:, :4])
