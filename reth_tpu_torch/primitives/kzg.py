"""KZG commitments over BLS12-381 — EIP-4844 point evaluation + blob ops.

A copy of the JAX package's ``primitives/kzg.py``.

Reference analogue: the c-kzg C library (reference Cargo.toml:597) behind
revm's point-evaluation precompile (0x0a) and the blob-sidecar validation
in the transaction pool.

Trusted setup: the mainnet KZG ceremony output is a data file the image
does not ship. The setup here is PLUGGABLE: ``load_trusted_setup(path)``
accepts the standard text format (`RETH_TPU_KZG_SETUP` env var at node
level), and absent one an INSECURE deterministic dev setup (known tau) is
generated — byte-compatible machinery, clearly unfit for mainnet, ideal
for tests which must produce and verify proofs end-to-end.
"""

from __future__ import annotations

import hashlib
import os
from functools import lru_cache

from .pairing import (
    BLS12_381,
    f2_neg,
    g1_group,
    g1_valid,
    g2_group,
    pairing_product_is_one,
)

BLS_MODULUS = BLS12_381.r
FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * 32
VERSIONED_HASH_VERSION_KZG = 0x01

# deterministic INSECURE dev tau (tests generate + verify with the same
# setup; mainnet requires the ceremony file via load_trusted_setup)
_DEV_TAU = int.from_bytes(hashlib.sha256(b"reth-tpu insecure dev kzg tau").digest(), "big") % BLS_MODULUS

_P = BLS12_381.p


class KzgError(ValueError):
    pass


# ---------------------------------------------------------------------------
# G1/G2 point (de)serialization — ZCash BLS12-381 compressed format
# ---------------------------------------------------------------------------


def _sqrt_fp(a: int) -> int | None:
    """Square root in Fp (p % 4 == 3)."""
    r = pow(a, (_P + 1) // 4, _P)
    return r if r * r % _P == a % _P else None


def g1_from_bytes(data: bytes):
    """48-byte compressed G1 -> affine point (or None for infinity).

    Raises KzgError for malformed encodings or off-curve/off-subgroup
    points (EIP-4844 requires full validation)."""
    if len(data) != 48:
        raise KzgError("G1 point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise KzgError("uncompressed G1 not supported")
    if flags & 0x40:
        if any(data[1:]) or flags != 0xC0:
            raise KzgError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= _P:
        raise KzgError("G1 x out of range")
    y = _sqrt_fp((x * x % _P * x + BLS12_381.b) % _P)
    if y is None:
        raise KzgError("G1 x not on curve")
    is_largest = y > (_P - 1) // 2
    if bool(flags & 0x20) != is_largest:
        y = _P - y
    pt = (x, y)
    if not g1_valid(pt, BLS12_381):
        raise KzgError("G1 point not in subgroup")
    return pt


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + b"\x00" * 47
    x, y = pt
    flags = 0x80 | (0x20 if y > (_P - 1) // 2 else 0)
    raw = x.to_bytes(48, "big")
    return bytes([raw[0] | flags]) + raw[1:]


def _sqrt_fp2(a: tuple[int, int]) -> tuple[int, int] | None:
    """Square root in Fp2 = Fp(u), u^2 = -1, via the norm trick."""
    a0, a1 = a
    if a1 == 0:
        r = _sqrt_fp(a0)
        if r is not None:
            return (r, 0)
        # a0 = -(b1^2) => sqrt = b1 * u
        r = _sqrt_fp((-a0) % _P)
        return (0, r) if r is not None else None
    n = _sqrt_fp((a0 * a0 + a1 * a1) % _P)
    if n is None:
        return None
    for s in (n, (-n) % _P):
        t = (a0 + s) * pow(2, _P - 2, _P) % _P
        alpha = _sqrt_fp(t)
        if alpha is None or alpha == 0:
            continue
        beta = a1 * pow(2 * alpha, _P - 2, _P) % _P
        cand = (alpha, beta)
        from .pairing import f2_sqr

        if f2_sqr(cand, _P) == (a0 % _P, a1 % _P):
            return cand
    return None


def g2_from_bytes(data: bytes):
    """96-byte compressed G2 -> twist affine point (or None)."""
    if len(data) != 96:
        raise KzgError("G2 point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise KzgError("uncompressed G2 not supported")
    if flags & 0x40:
        if any(data[1:]) or flags != 0xC0:
            raise KzgError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")  # c1 first
    x0 = int.from_bytes(data[48:96], "big")
    if x1 >= _P or x0 >= _P:
        raise KzgError("G2 x out of range")
    x = (x0, x1)
    from .pairing import f2_add, f2_mul, f2_sqr

    rhs = f2_add(f2_mul(f2_sqr(x, _P), x, _P), g2_group(BLS12_381).b, _P)
    y = _sqrt_fp2(rhs)
    if y is None:
        raise KzgError("G2 x not on curve")
    # "largest" is lexicographic over (c1, c0)
    is_largest = (y[1] > (_P - 1) // 2) or (y[1] == 0 and y[0] > (_P - 1) // 2)
    if bool(flags & 0x20) != is_largest:
        y = f2_neg(y, _P)
    pt = (x, y)
    from .pairing import g2_valid

    if not g2_valid(pt, BLS12_381):
        raise KzgError("G2 point not in subgroup")
    return pt


# ---------------------------------------------------------------------------
# trusted setup
# ---------------------------------------------------------------------------


class TrustedSetup:
    """tau*G2 (verification) + monomial G1 powers (commit/prove paths)."""

    def __init__(self, tau_g2, g1_monomial: list):
        self.tau_g2 = tau_g2
        self.g1_monomial = g1_monomial  # [tau^i * G1]


@lru_cache(maxsize=1)
def dev_setup(n_g1: int = 64) -> TrustedSetup:
    """Deterministic INSECURE setup from a known tau (tests only)."""
    g1 = g1_group(BLS12_381)
    g2 = g2_group(BLS12_381)
    powers = []
    acc = 1
    for _ in range(n_g1):
        powers.append(g1.mul_scalar(BLS12_381.g1, acc))
        acc = acc * _DEV_TAU % BLS_MODULUS
    return TrustedSetup(g2.mul_scalar(BLS12_381.g2, _DEV_TAU), powers)


_active_setup: TrustedSetup | None = None


def load_trusted_setup(path: str) -> TrustedSetup:
    """Parse the standard trusted_setup.txt format: first line n_g1, second
    n_g2, then n_g1 hex G1 points (Lagrange), then n_g2 hex G2 points
    (monomial — index 1 is tau*G2)."""
    global _active_setup
    with open(path) as f:
        tokens = f.read().split()
    n1, n2 = int(tokens[0]), int(tokens[1])
    g1_pts = [g1_from_bytes(bytes.fromhex(t)) for t in tokens[2 : 2 + n1]]
    g2_pts = [g2_from_bytes(bytes.fromhex(t)) for t in tokens[2 + n1 : 2 + n1 + n2]]
    if len(g2_pts) < 2:
        raise KzgError("setup missing tau*G2")
    setup = TrustedSetup(g2_pts[1], g1_pts)
    _active_setup = setup
    return setup


def active_setup() -> TrustedSetup:
    global _active_setup
    if _active_setup is None:
        path = os.environ.get("RETH_TPU_KZG_SETUP")
        _active_setup = load_trusted_setup(path) if path else dev_setup()
    return _active_setup


# ---------------------------------------------------------------------------
# KZG verification / commitment
# ---------------------------------------------------------------------------


def verify_kzg_proof(commitment, z: int, y: int, proof) -> bool:
    """e(C - y*G1, G2) == e(proof, tau*G2 - z*G2) via one product check."""
    setup = active_setup()
    g1 = g1_group(BLS12_381)
    g2 = g2_group(BLS12_381)
    p_minus_y = g1.padd(commitment, g1.mul_scalar(BLS12_381.g1, (-y) % BLS_MODULUS))
    x_minus_z = g2.padd(setup.tau_g2, g2.mul_scalar(BLS12_381.g2, (-z) % BLS_MODULUS))
    neg_g2 = (BLS12_381.g2[0], f2_neg(BLS12_381.g2[1], _P))
    return pairing_product_is_one(
        [(p_minus_y, neg_g2), (proof, x_minus_z)], BLS12_381
    )


def commit_monomial(coeffs: list[int]) -> tuple:
    """Commitment to a polynomial given in monomial form (tests/blob ops)."""
    setup = active_setup()
    if len(coeffs) > len(setup.g1_monomial):
        raise KzgError("polynomial degree exceeds setup size")
    g1 = g1_group(BLS12_381)
    acc = None
    for c, pt in zip(coeffs, setup.g1_monomial):
        if c % BLS_MODULUS:
            acc = g1.padd(acc, g1.mul_scalar(pt, c % BLS_MODULUS))
    return acc


def prove_monomial(coeffs: list[int], z: int) -> tuple[int, tuple]:
    """(y, proof) for p(z) on a monomial-form polynomial: commit to the
    quotient q(X) = (p(X) - y) / (X - z) by synthetic division."""
    y = 0
    for c in reversed(coeffs):
        y = (y * z + c) % BLS_MODULUS
    # synthetic division of (p(X) - y) by (X - z)
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % BLS_MODULUS
        q[i - 1] = carry
    return y, commit_monomial(q)


def kzg_to_versioned_hash(commitment_bytes: bytes) -> bytes:
    return bytes([VERSIONED_HASH_VERSION_KZG]) + hashlib.sha256(commitment_bytes).digest()[1:]


# ---------------------------------------------------------------------------
# blob-level operations (EIP-4844 polynomial-in-evaluation-form)
# ---------------------------------------------------------------------------
#
# A blob is FIELD_ELEMENTS evaluations of a polynomial at the roots of
# unity in bit-reversal permutation order. The blob size tracks the active
# setup: the mainnet ceremony file gives 4096; the insecure dev setup
# commits to dev_blob_size()-element mini-blobs so tests can run the full
# commit/prove/verify cycle in pure Python.

_PRIMITIVE_ROOT = 7  # generator of the BLS scalar field's 2^32 subgroup


def _bit_reverse(n: int, bits: int) -> int:
    return int(bin(n)[2:].zfill(bits)[::-1], 2)


@lru_cache(maxsize=4)
def _roots_of_unity(n: int) -> tuple[int, ...]:
    """n-th roots of unity in BIT-REVERSAL order (the 4844 blob layout)."""
    root = pow(_PRIMITIVE_ROOT, (BLS_MODULUS - 1) // n, BLS_MODULUS)
    seq = []
    acc = 1
    for _ in range(n):
        seq.append(acc)
        acc = acc * root % BLS_MODULUS
    bits = n.bit_length() - 1
    return tuple(seq[_bit_reverse(i, bits)] for i in range(n))


def active_blob_size() -> int:
    """Field elements per blob for the ACTIVE setup (4096 on mainnet)."""
    n = len(active_setup().g1_monomial)
    # largest power of two the monomial setup can commit to
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def blob_to_fields(blob: bytes) -> list[int]:
    if len(blob) % 32:
        raise KzgError("blob length not a multiple of 32")
    fields = [int.from_bytes(blob[i : i + 32], "big") for i in range(0, len(blob), 32)]
    if any(f >= BLS_MODULUS for f in fields):
        raise KzgError("blob field element out of range")
    return fields


def _evals_to_coeffs(evals: list[int]) -> list[int]:
    """Inverse DFT over the bit-reversed roots (O(n^2): dev-sized blobs)."""
    n = len(evals)
    roots = _roots_of_unity(n)
    inv_n = pow(n, BLS_MODULUS - 2, BLS_MODULUS)
    coeffs = []
    for j in range(n):
        s = 0
        for i, e in enumerate(evals):
            s += e * pow(roots[i], (BLS_MODULUS - 1 - j) % (BLS_MODULUS - 1), BLS_MODULUS)
        coeffs.append(s % BLS_MODULUS * inv_n % BLS_MODULUS)
    return coeffs


def blob_to_kzg_commitment(blob: bytes) -> bytes:
    fields = blob_to_fields(blob)
    if len(fields) != active_blob_size():
        raise KzgError(
            f"blob must hold {active_blob_size()} field elements for this setup"
        )
    return g1_to_bytes(commit_monomial(_evals_to_coeffs(fields)))


def _evaluate_in_evaluation_form(fields: list[int], z: int) -> int:
    """p(z) via the barycentric formula (no coefficient conversion)."""
    n = len(fields)
    roots = _roots_of_unity(n)
    for i, w in enumerate(roots):
        if w == z % BLS_MODULUS:
            return fields[i]
    total = 0
    for i, w in enumerate(roots):
        total += fields[i] * w % BLS_MODULUS * pow(z - w, BLS_MODULUS - 2, BLS_MODULUS)
    zn = (pow(z, n, BLS_MODULUS) - 1) % BLS_MODULUS
    inv_n = pow(n, BLS_MODULUS - 2, BLS_MODULUS)
    return total % BLS_MODULUS * zn % BLS_MODULUS * inv_n % BLS_MODULUS


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes) -> bytes:
    """Proof of evaluation at the Fiat-Shamir challenge (spec scheme)."""
    fields = blob_to_fields(blob)
    z = _blob_challenge(blob, commitment_bytes)
    coeffs = _evals_to_coeffs(fields)
    _y, proof = prove_monomial(coeffs, z)
    return g1_to_bytes(proof)


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes,
                          proof_bytes: bytes) -> bool:
    try:
        fields = blob_to_fields(blob)
        commitment = g1_from_bytes(commitment_bytes)
        proof = g1_from_bytes(proof_bytes)
    except KzgError:
        return False
    if len(fields) != active_blob_size():
        return False
    z = _blob_challenge(blob, commitment_bytes)
    y = _evaluate_in_evaluation_form(fields, z)
    return verify_kzg_proof(commitment, z, y, proof)


def _blob_challenge(blob: bytes, commitment_bytes: bytes) -> int:
    """Fiat-Shamir evaluation point binding blob + commitment
    (consensus-specs compute_challenge: domain || degree as 16-byte
    BIG-endian || blob || commitment, hashed to a field element)."""
    n = len(blob) // 32
    data = b"FSBLOBVERIFY_V1_" + n.to_bytes(16, "big") + blob + commitment_bytes
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % BLS_MODULUS
