"""Blake2b compression function F — the EIP-152 precompile core.

A copy of the JAX package's ``primitives/blake2.py``.

Reference analogue: revm's blake2 precompile crate (consumed by the
reference through revm; precompile 0x09 since Istanbul). Only the raw
F function is exposed — the precompile calls it with an explicit round
count, so this is not a full blake2b hash.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _MASK


def blake2f(rounds: int, h: list[int], m: list[int], t0: int, t1: int,
            final: bool) -> list[int]:
    """The F compression function: ``rounds`` rounds over state ``h``
    (8 u64) with message block ``m`` (16 u64) and offset counters."""
    v = list(h) + list(IV)
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _MASK

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _MASK
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _MASK
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]
