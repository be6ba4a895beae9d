"""Generic pairing engine over pairing-friendly curves (BN254, BLS12-381).

A copy of the JAX package's ``primitives/pairing.py``.

Reference analogue: the reference consumes these through native libs —
bn254 via revm's precompile crates and BLS12-381/KZG via c-kzg
(reference Cargo.toml:597). Here the math is implemented once, from the
curve equations up, parameterized by a :class:`Curve` config.

Design notes:
- Fp2 is (a, b) = a + b*u with u^2 = -1 (true for both supported curves).
- Fp12 is a FLAT polynomial basis 1, w, ..., w^11 with the single
  reduction w^12 = 2*x0*w^6 - (x0^2+1), derived from w^6 = xi = x0 + u.
  This avoids a three-level tower; multiplication is schoolbook 12x12.
- The pairing is the REDUCED TATE PAIRING with denominator elimination
  (even embedding degree): Miller loop over the 255-bit group order with
  G1 arithmetic in Fp and line evaluations at the untwisted G2 point in
  Fp12, then one final exponentiation to (p^12-1)/r.
  Correctness argument for consumers: every non-degenerate bilinear
  pairing on (G1, G2) into mu_r is a fixed power of every other, so
  product-equals-one checks (EIP-197) and pairing-equality checks (KZG)
  are invariant across pairing choices; bilinearity + non-degeneracy are
  pinned by tests/test_pairing.py property tests.
- Pure Python by design: precompile traffic is rare and correctness-
  critical; the batched hashing planes live on the device instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

# ---------------------------------------------------------------------------
# curve configurations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Curve:
    name: str
    p: int                      # base field prime
    r: int                      # prime subgroup order
    b: int                      # G1: y^2 = x^3 + b
    b2: tuple[int, int]         # twist: y^2 = x^3 + b2 (over Fp2)
    x0: int                     # xi = x0 + u (w^6 = xi)
    m_twist: bool               # M-twist (untwist divides by w^2/w^3)
    g1: tuple[int, int]
    g2: tuple[tuple[int, int], tuple[int, int]]


_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BN_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# 3 / (9 + u) in Fp2: (9 - u) * 3 / 82
_BN_B2 = (
    19485874751759354771024239261021720505790618469301721065564631296452457478373,
    266929791119991161246907387137283842545076965332900288569378510910307636690,
)

BN254 = Curve(
    name="bn254",
    p=_BN_P,
    r=_BN_R,
    b=3,
    b2=_BN_B2,
    x0=9,
    m_twist=False,
    g1=(1, 2),
    g2=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
)

_BLS_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16,
)
_BLS_R = int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16)

BLS12_381 = Curve(
    name="bls12_381",
    p=_BLS_P,
    r=_BLS_R,
    b=4,
    b2=(4, 4),                  # 4 * (1 + u): M-twist
    x0=1,
    m_twist=True,
    g1=(
        int("17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb", 16),
        int("08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
            "d03cc744a2888ae40caa232946c5e7e1", 16),
    ),
    g2=(
        (
            int("024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
                "0bac0326a805bbefd48056c8c121bdb8", 16),
            int("13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
                "334cf11213945d57e5ac7d055d042b7e", 16),
        ),
        (
            int("0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
                "923ac9cc3baca289e193548608b82801", 16),
            int("0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
                "3f370d275cec1da1aaa9075ff05f79be", 16),
        ),
    ),
)


# ---------------------------------------------------------------------------
# Fp / Fp2 arithmetic (tuples, module functions — hot enough to stay flat)
# ---------------------------------------------------------------------------


def _inv(a: int, p: int) -> int:
    if a == 0:
        raise ZeroDivisionError("field inverse of 0")
    return pow(a, p - 2, p)


def f2_add(a, b, p):
    return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)


def f2_sub(a, b, p):
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def f2_mul(a, b, p):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % p, (t2 - t0 - t1) % p)


def f2_sqr(a, p):
    # (a0+a1u)^2 = (a0-a1)(a0+a1) + 2a0a1 u
    return ((a[0] - a[1]) * (a[0] + a[1]) % p, 2 * a[0] * a[1] % p)


def f2_neg(a, p):
    return ((-a[0]) % p, (-a[1]) % p)


def f2_inv(a, p):
    n = _inv((a[0] * a[0] + a[1] * a[1]) % p, p)
    return (a[0] * n % p, (-a[1]) * n % p)


def f2_scalar(a, k: int, p):
    return (a[0] * k % p, a[1] * k % p)


# ---------------------------------------------------------------------------
# generic affine short-Weierstrass point ops (field ops injected)
# ---------------------------------------------------------------------------


class _Group:
    """Affine group law over a generic field (Fp as ints or Fp2 as tuples)."""

    def __init__(self, p, b, add, sub, mul, sqr, neg, inv, zero, scalar3, scalar2):
        self.p, self.b = p, b
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.zero = neg, inv, zero
        self.scalar3, self.scalar2 = scalar3, scalar2  # multiply by 3 / by 2

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.sqr(y)
        rhs = self.add(self.mul(self.sqr(x), x), self.b)
        return lhs == rhs

    def double(self, pt):
        if pt is None:
            return None
        x, y = pt
        if y == self.zero:
            return None
        lam = self.mul(self.scalar3(self.sqr(x)), self.inv(self.scalar2(y)))
        x3 = self.sub(self.sub(self.sqr(lam), x), x)
        y3 = self.sub(self.mul(lam, self.sub(x, x3)), y)
        return (x3, y3)

    def padd(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        if a[0] == b[0]:
            if a[1] == b[1]:
                return self.double(a)
            return None
        lam = self.mul(self.sub(b[1], a[1]), self.inv(self.sub(b[0], a[0])))
        x3 = self.sub(self.sub(self.sqr(lam), a[0]), b[0])
        y3 = self.sub(self.mul(lam, self.sub(a[0], x3)), a[1])
        return (x3, y3)

    def mul_scalar(self, pt, k: int):
        acc = None
        add = pt
        while k:
            if k & 1:
                acc = self.padd(acc, add)
            add = self.double(add)
            k >>= 1
        return acc


@lru_cache(maxsize=None)
def g1_group(curve: Curve) -> _Group:
    p = curve.p
    return _Group(
        p, curve.b % p,
        add=lambda a, b: (a + b) % p, sub=lambda a, b: (a - b) % p,
        mul=lambda a, b: a * b % p, sqr=lambda a: a * a % p,
        neg=lambda a: (-a) % p, inv=lambda a: _inv(a, p), zero=0,
        scalar3=lambda a: 3 * a % p, scalar2=lambda a: 2 * a % p,
    )


@lru_cache(maxsize=None)
def g2_group(curve: Curve) -> _Group:
    p = curve.p
    return _Group(
        p, (curve.b2[0] % p, curve.b2[1] % p),
        add=lambda a, b: f2_add(a, b, p), sub=lambda a, b: f2_sub(a, b, p),
        mul=lambda a, b: f2_mul(a, b, p), sqr=lambda a: f2_sqr(a, p),
        neg=lambda a: f2_neg(a, p), inv=lambda a: f2_inv(a, p), zero=(0, 0),
        scalar3=lambda a: f2_scalar(a, 3, p), scalar2=lambda a: f2_scalar(a, 2, p),
    )


# ---------------------------------------------------------------------------
# flat Fp12: 12-tuple of Fp coefficients over basis w^i,
# reduced by w^12 = 2*x0*w^6 - (x0^2 + 1)
# ---------------------------------------------------------------------------


def f12_one(curve) -> tuple:
    return (1,) + (0,) * 11


def f12_mul(a, b, curve):
    p = curve.p
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                if bj:
                    t[i + j] += ai * bj
    c1 = 2 * curve.x0
    c0 = -(curve.x0 * curve.x0 + 1)
    for k in range(22, 11, -1):
        v = t[k]
        if v:
            t[k - 6] += v * c1
            t[k - 12] += v * c0
            t[k] = 0
    return tuple(v % p for v in t[:12])


def f12_sqr(a, curve):
    return f12_mul(a, a, curve)


def f12_scalar(a, k: int, curve):
    p = curve.p
    return tuple(v * k % p for v in a)


def f12_add(a, b, curve):
    p = curve.p
    return tuple((x + y) % p for x, y in zip(a, b))


def f12_sub(a, b, curve):
    p = curve.p
    return tuple((x - y) % p for x, y in zip(a, b))


def f12_pow(a, e: int, curve):
    result = f12_one(curve)
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base, curve)
        base = f12_sqr(base, curve)
        e >>= 1
    return result


def f12_embed2(a2, curve):
    """Fp2 element a + b*u -> flat Fp12 (u = w^6 - x0)."""
    a, b = a2
    v = [0] * 12
    v[0] = (a - curve.x0 * b) % curve.p
    v[6] = b % curve.p
    return tuple(v)


def _wshift(a, k: int, curve):
    """Multiply by w^k (k < 12) and reduce."""
    t = [0] * 23
    for i, ai in enumerate(a):
        t[i + k] = ai
    p = curve.p
    c1 = 2 * curve.x0
    c0 = -(curve.x0 * curve.x0 + 1)
    for kk in range(22, 11, -1):
        v = t[kk]
        if v:
            t[kk - 6] += v * c1
            t[kk - 12] += v * c0
            t[kk] = 0
    return tuple(v % p for v in t[:12])


@lru_cache(maxsize=None)
def _untwist_consts(curve: Curve):
    """Fp12 constants (cx, cy) with untwist(x', y') = (embed(x')*cx,
    embed(y')*cy). D-twist multiplies by w^2/w^3; M-twist divides —
    and w^-k = w^(6-k) * xi^-1 with xi^-1 a cheap Fp2 inverse."""
    p = curve.p
    if not curve.m_twist:
        cx = _wshift(f12_one(curve), 2, curve)
        cy = _wshift(f12_one(curve), 3, curve)
        return cx, cy
    xi_inv = f2_inv((curve.x0, 1), p)
    inv12 = f12_embed2(xi_inv, curve)
    cx = _wshift(inv12, 4, curve)   # w^-2 = w^4 * xi^-1
    cy = _wshift(inv12, 3, curve)   # w^-3 = w^3 * xi^-1
    return cx, cy


def untwist(q, curve):
    """Twist-curve G2 point (Fp2 affine) -> E(Fp12) affine."""
    cx, cy = _untwist_consts(curve)
    x = f12_mul(f12_embed2(q[0], curve), cx, curve)
    y = f12_mul(f12_embed2(q[1], curve), cy, curve)
    return x, y


# ---------------------------------------------------------------------------
# reduced Tate pairing (denominator elimination)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _final_exp_power(curve: Curve) -> int:
    return (curve.p ** 12 - 1) // curve.r


def miller_loop(p1, q2, curve):
    """Unreduced f_{r,P}(psi(Q)) for P in G1 (Fp affine), Q in G2 (twist
    Fp2 affine). Verticals are eliminated (wiped by the final exp)."""
    if p1 is None or q2 is None:
        return f12_one(curve)
    p = curve.p
    xq, yq = untwist(q2, curve)

    def line(t, s):
        """l_{T,S}(Q) in Fp12, or None for verticals (eliminated by the
        final exponentiation — even embedding degree)."""
        if t is None or s is None:
            return None
        xt, yt = t
        xs, ys = s
        if xt == xs and yt == ys:
            if yt == 0:
                return None
            lam = 3 * xt * xt * _inv(2 * yt, p) % p
        elif xt == xs:
            return None
        else:
            lam = (ys - yt) * _inv((xs - xt) % p, p) % p
        # l(Q) = lam*xQ - yQ + (yt - lam*xt)
        val = f12_sub(f12_scalar(xq, lam, curve), yq, curve)
        const = (yt - lam * xt) % p
        return ((val[0] + const) % p,) + val[1:]

    g = g1_group(curve)
    f = f12_one(curve)
    t = p1
    for bit in bin(curve.r)[3:]:
        f = f12_sqr(f, curve)
        l = line(t, t)
        if l is not None:
            f = f12_mul(f, l, curve)
        t = g.double(t)
        if bit == "1":
            l = line(t, p1)
            if l is not None:
                f = f12_mul(f, l, curve)
            t = g.padd(t, p1)
    return f


def pairing(p1, q2, curve) -> tuple:
    """Reduced Tate pairing e(P, Q) in mu_r (flat Fp12)."""
    return f12_pow(miller_loop(p1, q2, curve), _final_exp_power(curve), curve)


def pairing_product_is_one(pairs, curve) -> bool:
    """prod e(Pi, Qi) == 1 with a single final exponentiation."""
    f = f12_one(curve)
    for p1, q2 in pairs:
        f = f12_mul(f, miller_loop(p1, q2, curve), curve)
    return f12_pow(f, _final_exp_power(curve), curve) == f12_one(curve)


# ---------------------------------------------------------------------------
# subgroup / curve checks
# ---------------------------------------------------------------------------


def g1_valid(pt, curve) -> bool:
    """On-curve (+ subgroup when the cofactor is nontrivial, i.e. BLS)."""
    g = g1_group(curve)
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < curve.p and 0 <= y < curve.p) or not g.on_curve(pt):
        return False
    if curve.name == "bn254":
        return True  # cofactor 1
    return g.mul_scalar(pt, curve.r) is None


def g2_valid(pt, curve) -> bool:
    """On-twist-curve + r-torsion (G2 cofactors are large for both)."""
    g = g2_group(curve)
    if pt is None:
        return True
    (x0_, x1_), (y0_, y1_) = pt
    if not all(0 <= c < curve.p for c in (x0_, x1_, y0_, y1_)):
        return False
    if not g.on_curve(pt):
        return False
    return g.mul_scalar(pt, curve.r) is None
