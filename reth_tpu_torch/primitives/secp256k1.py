"""secp256k1 ECDSA: sign + public-key recovery (sender recovery).

A copy of the JAX package's ``primitives/secp256k1.py`` with one departure
kept on purpose: ``ecrecover_batch`` runs the native batch
(``csrc/secp256k1.cpp``, a copy of the reference's ``rtsecp_recover_batch``)
only, and a failed g++ build raises instead of falling back to the
pure-Python point math. ``ecrecover`` for one signature stays pure Python:
single-sender recovery and the ecrecover precompile use it, and it is the
plain version the batch is tested against.

Reference analogue: the C secp256k1 library (reference Cargo.toml:592), used
for `SenderRecoveryStage` and ECIES. This is a portable pure-Python
implementation (Jacobian point arithmetic, RFC-6979 deterministic nonces);
the batched/NATIVE fast path belongs to the C++ runtime layer in a later
milestone — interfaces here are the stable seam.
"""

from __future__ import annotations

import hashlib
import hmac

from .keccak import keccak256

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_JPoint = tuple[int, int, int]  # Jacobian (X, Y, Z); Z=0 → infinity
_INF: _JPoint = (1, 1, 0)


def _jdouble(p: _JPoint) -> _JPoint:
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    s = (4 * x * y * y) % P
    m = (3 * x * x) % P  # a = 0 for secp256k1
    x3 = (m * m - 2 * s) % P
    y3 = (m * (s - x3) - 8 * y * y * y * y) % P
    z3 = (2 * y * z) % P
    return (x3, y3, z3)


def _jadd(p: _JPoint, q: _JPoint) -> _JPoint:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return _INF
        return _jdouble(p)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = h * h % P
    h3 = h2 * h % P
    x3 = (r * r - h3 - 2 * u1 * h2) % P
    y3 = (r * (u1 * h2 - x3) - s1 * h3) % P
    z3 = h * z1 * z2 % P
    return (x3, y3, z3)


def _jmul(p: _JPoint, k: int) -> _JPoint:
    k %= N
    result = _INF
    addend = p
    while k:
        if k & 1:
            result = _jadd(result, addend)
        addend = _jdouble(addend)
        k >>= 1
    return result


def _to_affine(p: _JPoint) -> tuple[int, int]:
    x, y, z = p
    if z == 0:
        raise ValueError("point at infinity")
    zinv = pow(z, P - 2, P)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 * zinv % P)


_G: _JPoint = (GX, GY, 1)


def random_priv() -> int:
    """Uniform nonzero scalar (rejection sampling, no mod bias)."""
    import os

    while True:
        k = int.from_bytes(os.urandom(32), "big")
        if 1 <= k < N:
            return k


def pubkey_from_priv(priv: int) -> tuple[int, int]:
    return _to_affine(_jmul(_G, priv))


def address_from_pubkey(pub: tuple[int, int]) -> bytes:
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return keccak256(raw)[12:]


def address_from_priv(priv: int) -> bytes:
    return address_from_pubkey(pubkey_from_priv(priv))


def pubkey_to_bytes(pub: tuple[int, int]) -> bytes:
    """Uncompressed 64-byte X||Y (devp2p node-id / ECIES encoding)."""
    return pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def pubkey_from_bytes(raw: bytes) -> tuple[int, int]:
    """64-byte X||Y -> validated curve point."""
    if len(raw) != 64:
        raise ValueError("public key must be 64 bytes")
    x = int.from_bytes(raw[:32], "big")
    y = int.from_bytes(raw[32:], "big")
    if not (0 < x < P and 0 < y < P) or (y * y - (x * x * x + 7)) % P != 0:
        raise ValueError("point not on secp256k1")
    return (x, y)


def compress_pubkey(pub: tuple[int, int]) -> bytes:
    """SEC1 compressed form: 02/03 parity prefix + 32-byte X (the ENR
    "secp256k1" value and discv5 ephemeral-key encoding)."""
    return bytes([2 + (pub[1] & 1)]) + pub[0].to_bytes(32, "big")


def decompress_pubkey(raw: bytes) -> tuple[int, int]:
    """SEC1 compressed (33 B) or uncompressed 04-prefixed (65 B) -> point."""
    if len(raw) == 65 and raw[0] == 4:
        return pubkey_from_bytes(raw[1:])
    if len(raw) != 33 or raw[0] not in (2, 3):
        raise ValueError("bad compressed public key")
    x = int.from_bytes(raw[1:], "big")
    if not 0 < x < P:
        raise ValueError("x out of range")
    y = pow((x * x * x + 7) % P, (P + 1) // 4, P)
    if (y * y) % P != (x * x * x + 7) % P:
        raise ValueError("point not on secp256k1")
    if (y & 1) != (raw[0] & 1):
        y = P - y
    return (x, y)


def ecdh_x(priv: int, pub: tuple[int, int]) -> bytes:
    """ECDH shared secret: x-coordinate of priv * pub (32 bytes big-endian).

    The devp2p/ECIES convention (reference crates/net/ecies): only the x
    coordinate feeds the KDF."""
    x, _y = _to_affine(_jmul((pub[0], pub[1], 1), priv))
    return x.to_bytes(32, "big")


def _rfc6979_k(msg_hash: bytes, priv: int):
    """Deterministic nonce candidates per RFC 6979 with HMAC-SHA256.

    Yields successive candidates (sec 3.2 step h retry) so callers can pull
    another nonce if r or s comes out zero, without touching the message.
    """
    x = priv.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(msg_hash: bytes, priv: int) -> tuple[int, int, int]:
    """ECDSA sign → (y_parity, r, s) with low-s normalisation (EIP-2)."""
    z = int.from_bytes(msg_hash, "big")
    for k in _rfc6979_k(msg_hash, priv):
        rx, ry = _to_affine(_jmul(_G, k))
        r = rx % N
        if r == 0:
            continue  # next RFC-6979 candidate
        s = pow(k, N - 2, N) * (z + r * priv) % N
        if s == 0:
            continue
        parity = ry & 1
        if s > N // 2:
            s = N - s
            parity ^= 1
        return (parity, r, s)
    raise AssertionError("unreachable: RFC-6979 generator is infinite")


def _native_lib():
    """ctypes handle to ``csrc/secp256k1.cpp``, built by g++ into the
    port's build directory on first use (``ops/_build.py``). A failed build
    raises its ``BuildError``: the batch has no pure-Python fallback."""
    import ctypes

    from ..ops._build import PKG_DIR, load

    lib = load(PKG_DIR / "csrc" / "secp256k1.cpp")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rtsecp_recover_batch.argtypes = [
        u8p, u8p, u8p, u8p, ctypes.c_uint64, u8p, u8p, ctypes.c_int,
    ]
    lib.rtsecp_recover_batch.restype = None
    return lib


def ecrecover_batch(items, allow_high_s: bool = False) -> list[bytes | None]:
    """Batch address recovery: ``items`` = (msg_hash, y_parity, r, s) tuples;
    returns one 20-byte address (or None for invalid signatures) per item.

    The hot path is the native threaded C++ engine (native/secp256k1.cpp,
    the reference's C-secp256k1 + rayon analogue); scalar validation and
    u1/u2 = (-z, s) * r^-1 mod n stay in Python big ints. A failed native
    build raises; there is no pure-Python fallback."""
    lib = _native_lib()
    import ctypes

    n = len(items)
    r_buf = bytearray(32 * n)
    parity = bytearray(n)
    u1_buf = bytearray(32 * n)
    u2_buf = bytearray(32 * n)
    valid = bytearray(n)  # python-side validation verdict
    for i, (h, y, r, s) in enumerate(items):
        if not (1 <= r < N and 1 <= s < N) or y not in (0, 1):
            continue
        if s > N // 2 and not allow_high_s:
            continue
        z = int.from_bytes(h, "big")
        r_inv = pow(r, -1, N)
        u1 = (-z) * r_inv % N
        u2 = s * r_inv % N
        r_buf[32 * i : 32 * i + 32] = r.to_bytes(32, "big")
        parity[i] = y
        u1_buf[32 * i : 32 * i + 32] = u1.to_bytes(32, "big")
        u2_buf[32 * i : 32 * i + 32] = u2.to_bytes(32, "big")
        valid[i] = 1
    out_buf = bytearray(64 * n)
    status = bytearray(n)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    as_p = lambda b: (ctypes.c_uint8 * len(b)).from_buffer(b)  # noqa: E731
    lib.rtsecp_recover_batch(
        ctypes.cast(as_p(r_buf), u8p), ctypes.cast(as_p(parity), u8p),
        ctypes.cast(as_p(u1_buf), u8p), ctypes.cast(as_p(u2_buf), u8p),
        n, ctypes.cast(as_p(out_buf), u8p), ctypes.cast(as_p(status), u8p), 0,
    )
    out: list[bytes | None] = []
    for i in range(n):
        if not valid[i] or status[i] != 0:
            out.append(None)
            continue
        out.append(keccak256(bytes(out_buf[64 * i : 64 * i + 64]))[12:])
    return out


def ecrecover(msg_hash: bytes, y_parity: int, r: int, s: int,
              allow_high_s: bool = False, return_pubkey: bool = False) -> bytes:
    """Recover the signer's address (or 64-byte pubkey) from a signature.

    Raises ValueError on invalid signatures (reference rejects these during
    sender recovery and tx validation). ``allow_high_s`` relaxes the EIP-2
    low-s rule for the ecrecover PRECOMPILE, which accepts any s in range.
    ``return_pubkey`` yields X||Y instead of the address (the RLPx
    handshake recovers the peer's EPHEMERAL public key this way).
    """
    if y_parity not in (0, 1):
        raise ValueError("invalid recovery id")
    if not (1 <= r < N and 1 <= s < N):
        raise ValueError("signature out of range")
    # EIP-2 (homestead): high-s signatures are invalid for tx senders.
    if s > N // 2 and not allow_high_s:
        raise ValueError("high-s signature")
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        raise ValueError("invalid r: not on curve")
    if y & 1 != y_parity:
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    r_inv = pow(r, N - 2, N)
    # Q = r^-1 (s*R - z*G)
    point = _jadd(_jmul((x, y, 1), s), _jmul(_G, (-z) % N))
    q = _to_affine(_jmul(point, r_inv))
    if return_pubkey:
        return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return address_from_pubkey(q)
