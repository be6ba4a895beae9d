"""Minimal BLS12-381 arithmetic for the EIP-2537 precompiles.

A copy of the JAX package's ``primitives/bls12381.py``.

G1ADD (0x0b) / G2ADD (0x0d): Fp / Fp2 field ops and affine point addition
on y^2 = x^3 + 4 (G1) and y^2 = x^3 + 4(1+i) (G2). Per EIP-2537, ADD
inputs must be valid field encodings on the curve but do NOT require a
subgroup check; the point at infinity encodes as all zeros.

G1MSM (0x0c) / G2MSM (0x0e): multi-scalar multiplication built from
double-and-add over the SAME affine addition (the chord-tangent formula
handles doubling), so the group law lives in exactly one place. MSM
inputs DO require the subgroup check (EIP-2537: "subgroup check is
required" for MSM but not ADD), enforced by multiplying by the prime
subgroup order ``R`` — slow in python, but these precompiles are rare
enough on mainnet that constant-factor speed is irrelevant, while the
encode/validate rules are consensus-critical.

PAIRING (0x0f): the product-of-pairings check over the repo's own
pairing engine (primitives/pairing.py, reduced Tate pairing with one
final exponentiation for the whole product); every input point is
curve- AND subgroup-checked.

MAP_FP_TO_G1 (0x10) / MAP_FP2_TO_G2 (0x11): the RFC 9380 simplified-SWU
map to the isogenous curve E' followed by the 11-/3-isogeny back to the
BLS curve and effective-cofactor clearing. The isogeny rational maps
are NOT transcribed from the RFC appendix: they were re-derived offline
from first principles (the normalized isogeny satisfies the ODE
``(x^3 + A'x + B') F'^2 = F^3 + B_cod`` — solve it as a power series at
infinity, Padé-reconstruct the degree-11/10 rational map, then solve for
the unique codomain model admitting an exact solution) and the baked
constants are pinned two independent ways: the exact polynomial isogeny
identity (tests/test_precompiles.py) and end-to-end RFC 9380 J.9.1/J.10.1
hash-to-curve vectors, both of which any single-constant typo breaks.
"""

from __future__ import annotations

# the BLS12-381 base field prime
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# the prime order of the G1/G2 subgroups (the scalar field)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_B1 = 4            # G1 curve constant: y^2 = x^3 + 4
_B2 = (4, 4)       # G2 curve constant: 4 * (1 + i) in Fp2


class BlsError(ValueError):
    """Invalid EIP-2537 input (length, padding, range, or off-curve)."""


# -- Fp -----------------------------------------------------------------------


def _fp_decode(b: bytes) -> int:
    """One 64-byte padded field element: top 16 bytes zero, value < P."""
    if len(b) != 64:
        raise BlsError(f"field element must be 64 bytes, got {len(b)}")
    if b[:16] != b"\x00" * 16:
        raise BlsError("field element padding is not zero")
    v = int.from_bytes(b[16:], "big")
    if v >= P:
        raise BlsError("field element not in canonical range")
    return v


def _fp_encode(v: int) -> bytes:
    return b"\x00" * 16 + v.to_bytes(48, "big")


def _fp_inv(v: int) -> int:
    return pow(v, P - 2, P)


# -- Fp2 (c0 + c1*i with i^2 = -1) -------------------------------------------


def _fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fp2_inv(a):
    norm = _fp_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * norm % P, (-a[1]) * norm % P)


# -- affine point addition (shared shape over both fields) -------------------


def _add_affine(p1, p2, *, add, sub, mul, inv, zero):
    """Affine chord-tangent addition; ``None`` is the point at infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if add(y1, y2) == zero:  # P + (-P), including doubling a y=0 point
            return None
        # doubling: lambda = 3 x^2 / 2 y
        x_sq = mul(x1, x1)
        lam = mul(add(add(x_sq, x_sq), x_sq), inv(add(y1, y1)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    return (x3, y3)


def _g1_ops():
    return dict(add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
                mul=lambda a, b: (a * b) % P, inv=_fp_inv, zero=0)


def _g2_ops():
    return dict(add=_fp2_add, sub=_fp2_sub, mul=_fp2_mul, inv=_fp2_inv,
                zero=(0, 0))


# -- G1 -----------------------------------------------------------------------


def decode_g1(b: bytes):
    """128-byte G1 point (x||y); all-zero = infinity. On-curve checked
    (EIP-2537 ADD semantics: curve check yes, subgroup check no)."""
    if len(b) != 128:
        raise BlsError(f"G1 point must be 128 bytes, got {len(b)}")
    x = _fp_decode(b[:64])
    y = _fp_decode(b[64:])
    if x == 0 and y == 0:
        return None
    if (y * y - (x * x * x + _B1)) % P != 0:
        raise BlsError("G1 point not on curve")
    return (x, y)


def encode_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    return _fp_encode(pt[0]) + _fp_encode(pt[1])


def g1_add(p1, p2):
    return _add_affine(p1, p2, **_g1_ops())


def g1add_precompile(data: bytes) -> bytes:
    """EIP-2537 G1ADD: 256-byte input (two G1 points), 128-byte output."""
    if len(data) != 256:
        raise BlsError(f"G1ADD input must be 256 bytes, got {len(data)}")
    return encode_g1(g1_add(decode_g1(data[:128]), decode_g1(data[128:])))


# -- scalar multiplication / MSM (shared over both groups) --------------------


def _mul_scalar(pt, k: int, add):
    """Double-and-add via the affine group law (``add(p, p)`` doubles)."""
    acc = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def _check_subgroup(pt, add, what: str) -> None:
    """EIP-2537 MSM semantics: every input point must lie in the prime
    subgroup (infinity trivially does). Order-R multiplication is the
    definitionally-correct check — no endomorphism shortcuts to get wrong."""
    if pt is not None and _mul_scalar(pt, R, add) is not None:
        raise BlsError(f"{what} point not in the prime subgroup")


def _msm(data: bytes, pair_len: int, point_len: int, decode, encode, add,
         what: str) -> bytes:
    """Shared EIP-2537 MSM body: k (point, 32-byte scalar) pairs, every
    point curve- AND subgroup-checked, scalars unreduced big-endian ints
    (multiplication handles any magnitude). Empty input is invalid."""
    if len(data) == 0 or len(data) % pair_len != 0:
        raise BlsError(
            f"{what} input must be a positive multiple of {pair_len} bytes, "
            f"got {len(data)}")
    acc = None
    for off in range(0, len(data), pair_len):
        pt = decode(data[off:off + point_len])
        _check_subgroup(pt, add, what)
        scalar = int.from_bytes(data[off + point_len:off + pair_len], "big")
        acc = add(acc, _mul_scalar(pt, scalar, add))
    return encode(acc)


def g1_mul(pt, k: int):
    return _mul_scalar(pt, k, g1_add)


def g1msm_precompile(data: bytes) -> bytes:
    """EIP-2537 G1MSM: k*(G1 point ++ 32-byte scalar) -> 128-byte point."""
    return _msm(data, 160, 128, decode_g1, encode_g1, g1_add, "G1MSM")


# -- G2 -----------------------------------------------------------------------


def decode_g2(b: bytes):
    """256-byte G2 point (x_c0||x_c1||y_c0||y_c1); all-zero = infinity."""
    if len(b) != 256:
        raise BlsError(f"G2 point must be 256 bytes, got {len(b)}")
    x = (_fp_decode(b[0:64]), _fp_decode(b[64:128]))
    y = (_fp_decode(b[128:192]), _fp_decode(b[192:256]))
    if x == (0, 0) and y == (0, 0):
        return None
    rhs = _fp2_add(_fp2_mul(_fp2_mul(x, x), x), _B2)
    if _fp2_sub(_fp2_mul(y, y), rhs) != (0, 0):
        raise BlsError("G2 point not on curve")
    return (x, y)


def encode_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * 256
    (x, y) = pt
    return (_fp_encode(x[0]) + _fp_encode(x[1])
            + _fp_encode(y[0]) + _fp_encode(y[1]))


def g2_add(p1, p2):
    return _add_affine(p1, p2, **_g2_ops())


def g2add_precompile(data: bytes) -> bytes:
    """EIP-2537 G2ADD: 512-byte input (two G2 points), 256-byte output."""
    if len(data) != 512:
        raise BlsError(f"G2ADD input must be 512 bytes, got {len(data)}")
    return encode_g2(g2_add(decode_g2(data[:256]), decode_g2(data[256:])))


def g2_mul(pt, k: int):
    return _mul_scalar(pt, k, g2_add)


def g2msm_precompile(data: bytes) -> bytes:
    """EIP-2537 G2MSM: k*(G2 point ++ 32-byte scalar) -> 256-byte point."""
    return _msm(data, 288, 256, decode_g2, encode_g2, g2_add, "G2MSM")


# EIP-2537 MSM pricing: cost = k * multiplication_cost * discount(k) / 1000
# with the per-k discount table below (index k-1, capped at k=128). The
# table is transcribed from the EIP's final (Pectra) parameter set.
MSM_MULTIPLIER = 1000
G1MSM_BASE_GAS = 12000   # G1 multiplication cost
G2MSM_BASE_GAS = 22500   # G2 multiplication cost

G1_MSM_DISCOUNT = (
    1000, 949, 848, 797, 764, 750, 738, 728, 719, 712, 705, 698, 692, 687,
    682, 677, 673, 669, 665, 661, 658, 654, 651, 648, 645, 642, 640, 637,
    635, 632, 630, 627, 625, 623, 621, 619, 617, 615, 613, 611, 609, 608,
    606, 604, 603, 601, 599, 598, 596, 595, 593, 592, 591, 589, 588, 586,
    585, 584, 582, 581, 580, 579, 577, 576, 575, 574, 573, 572, 570, 569,
    568, 567, 566, 565, 564, 563, 562, 561, 560, 559, 558, 557, 556, 555,
    554, 553, 552, 551, 550, 549, 548, 547, 547, 546, 545, 544, 543, 542,
    541, 540, 540, 539, 538, 537, 536, 536, 535, 534, 533, 532, 532, 531,
    530, 529, 528, 528, 527, 526, 525, 525, 524, 523, 522, 522, 521, 520,
    520, 519,
)
G2_MSM_DISCOUNT = (
    1000, 1000, 923, 884, 855, 832, 812, 796, 782, 770, 759, 749, 740, 732,
    724, 717, 711, 704, 699, 693, 688, 683, 679, 674, 670, 666, 663, 659,
    655, 652, 649, 646, 643, 640, 637, 634, 632, 629, 627, 624, 622, 620,
    618, 615, 613, 611, 609, 607, 606, 604, 602, 600, 598, 597, 595, 593,
    592, 590, 589, 587, 586, 584, 583, 582, 580, 579, 578, 576, 575, 574,
    573, 571, 570, 569, 568, 567, 566, 565, 563, 562, 561, 560, 559, 558,
    557, 556, 555, 554, 553, 552, 552, 551, 550, 549, 548, 547, 546, 545,
    545, 544, 543, 542, 541, 541, 540, 539, 538, 537, 537, 536, 535, 535,
    534, 533, 532, 532, 531, 530, 530, 529, 528, 528, 527, 526, 526, 525,
    524, 524,
)


def msm_gas(k: int, base: int, discounts: tuple[int, ...]) -> int:
    """EIP-2537 MSM gas for k pairs (k >= 1)."""
    if k == 0:
        return 0
    d = discounts[min(k, len(discounts)) - 1]
    return (k * base * d) // MSM_MULTIPLIER


def g1msm_gas(k: int) -> int:
    return msm_gas(k, G1MSM_BASE_GAS, G1_MSM_DISCOUNT)


def g2msm_gas(k: int) -> int:
    return msm_gas(k, G2MSM_BASE_GAS, G2_MSM_DISCOUNT)


# the standard generators (draft-irtf-cfrg-bls-signature / EIP-2537 test
# vectors use them); exported for tests
G1_GENERATOR = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GENERATOR = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


# -- EIP-2537 PAIRING (0x0f) --------------------------------------------------

PAIRING_BASE_GAS = 37700
PAIRING_PAIR_GAS = 32600


def pairing_gas(k: int) -> int:
    return PAIRING_BASE_GAS + k * PAIRING_PAIR_GAS


def pairing_precompile(data: bytes) -> bytes:
    """EIP-2537 PAIRING: k*(G1 point ++ G2 point) -> 32-byte 0/1.

    Every point must be on its curve AND in the prime subgroup (unlike
    ADD, like MSM); the point at infinity is valid and contributes the
    identity. Empty input is invalid per the EIP (unlike EIP-197 bn254).
    The check itself — prod e(Pi, Qi) == 1 — runs on the repo's generic
    pairing engine with ONE final exponentiation for the whole product.
    """
    if len(data) == 0 or len(data) % 384 != 0:
        raise BlsError(
            f"PAIRING input must be a positive multiple of 384 bytes, "
            f"got {len(data)}")
    pairs = []
    for off in range(0, len(data), 384):
        p1 = decode_g1(data[off:off + 128])
        _check_subgroup(p1, g1_add, "PAIRING G1")
        q2 = decode_g2(data[off + 128:off + 384])
        _check_subgroup(q2, g2_add, "PAIRING G2")
        if p1 is not None and q2 is not None:
            pairs.append((p1, q2))
    from .pairing import BLS12_381, pairing_product_is_one

    ok = pairing_product_is_one(pairs, BLS12_381)
    return (1 if ok else 0).to_bytes(32, "big")


# -- EIP-2537 MAP_FP_TO_G1 / MAP_FP2_TO_G2 (0x10 / 0x11) ----------------------
#
# RFC 9380 simplified SWU onto the isogenous curve E', the 11-/3-isogeny
# back onto the BLS curve, then effective-cofactor clearing. See the
# module docstring for how the isogeny constants below were derived and
# how they are pinned.

MAP_FP_TO_G1_GAS = 5500
MAP_FP2_TO_G2_GAS = 23800

# G1 SSWU target curve E1': y^2 = x^3 + ISO1_A x + ISO1_B, Z = 11
ISO1_A = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
ISO1_B = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0
ISO1_Z = 11
# normalized 11-isogeny E1' -> y^2 = x^3 + ISO1_BCOD: x |-> N(x)/D(x)
# (monic-leading N over monic D), y |-> y * (N'D - ND')/D^2; the model is
# rescaled onto y^2 = x^3 + 4 by x *= ISO1_C (= s^2), y *= ISO1_S3 (= s^3)
ISO1_BCOD = 0x6C20A4
ISO1_C = 0x6E08C248E260E70BD1E962381EDEE3D31D79D7E22C837BC23C0BF1BC24C6B68C24B1B80B64D391FA9C8BA2E8BA2D229
ISO1_S3 = 0x15E6BE4E990F03CE4EA50B3B42DF2EB5CB181D8F84965A3957ADD4FA95AF01B2B665027EFEC01C7704B456BE69C8B604
# x-map numerator, index = degree (degree 11, monic)
ISO1_N = (
    0x753E5B010B5C2AED6CE5BA4AA4CF117B975DFEF6FF2C0A82E8D47835D0591EDAD4178B01E37966FBA894887C542CB9,
    0x1413C543388686BC391125039A3D376FA96FC987A0B99952DBC05E4A373FF99C5106B174C8985431036FF03DFB54EDEA,
    0x71D592BC054E3B8BFFC75B81AEFAFA0A97F03B9114CD1363513AECFEB7610341A16B39EC1F2DA1DF687186972AF9C6,
    0x5B098E05C2AABF1E6143C24142C25324C6DCC53AD565D704DE934AA345920B145B4FE75D201AEF640487751FE98AB0A,
    0x183F63E4654B1979AD4A84532F7E099D6D92B7C6EFC1D8B2FAA622E45E37EC2BFB991CE5556A9BDCA5545A728CA528D0,
    0x69E074638EEAB73A3B7B2E2FA9FC54B33B081FDBD70EF8B8D6758948AC6D2D388A13B2B8E7FE14E18BD96CAA6F2F41E,
    0xD20F79145EE9F35035EB4485A8940705E481DE8641F0C42165FDAD250DF0A5D84105C94491B1DF3CF4F73C93475EDFA,
    0x990B39B1545D7F3990CA675E6C070C715AF1AC4F6F9AAB95CD52B05E28FA1B119F5FE26C973A01F3089B1C3BCF375A4,
    0xC1A3784B0B69F918C6576E46B265C603ADC96424813AE770555D3D09DEC9EDB34FCDFD99B8024AAD8D60A58ABD6AB28,
    0x4E191198FB0B670F56E5BB36434C322563036138E4314008ACE68587DDB0A83824A49AF4209A889CE74C108E919F68B,
    0x95FC13AB9E92AD4476D6E3EB3A56680F682B4EE96F7D03776DF533978F31C1593174E4B4B7865002D6384D168ECDD0A,
    1,
)
# x-map denominator, index = degree (degree 10, monic)
ISO1_D = (
    0x8CA8D548CFF19AE18B2E62F4BD3FA6F01D5EF4BA35B48BA9C9588617FC8AC62B558D681BE343DF8993CF9FA40D21B1C,
    0x12561A5DEB559C4348B4711298E536367041E8CA0CF0800C0126C2588C48BF5713DAA8846CB026E9E5C8276EC82B3BFF,
    0xB2962FE57A3225E8137E629BFF2991F6F89416F5A718CD1FCA64E00B11ACEACD6A3D0967C94FEDCFCC239BA5CB83E19,
    0x3425581A58AE2FEC83AAFEF7C40EB545B08243F16B1655154CCA8ABC28D6FD04976D5243EECF5C4130DE8938DC62CD8,
    0x13A8E162022914A80A6F1D5F43E7A07DFFDFC759A12062BB8D6B44E833B306DA9BD29BA81F35781D539D395B3532A21E,
    0xE7355F8E4E667B955390F7F0506C6E9395735E9CE9CAD4D0A43BCEF24B8982F7400D24BC4228F11C02DF9A29F6304A5,
    0x772CAACF16936190F3E0C63E0596721570F5799AF53A1894E2E073062AEDE9CEA73B3538F0DE06CEC2574496EE84A3A,
    0x14A7AC2A9D64A8B230B3F5B074CF01996E7F63C21BCA68A81996E1CDF9822C580FA5B9489D11E2D311F7D99BBDCC5A5E,
    0xA10ECF6ADA54F825E920B3DAFC7A3CCE07F8D1D7161366B74100DA67F39883503826692ABBA43704776EC3A79A1D641,
    0x95FC13AB9E92AD4476D6E3EB3A56680F682B4EE96F7D03776DF533978F31C1593174E4B4B7865002D6384D168ECDD0A,
    1,
)
# G1 effective cofactor (RFC 9380 8.8.1: h_eff = 1 - x_BLS)
H_EFF_G1 = 0xD201000000010001

# G2 SSWU target curve E2': y^2 = x^3 + ISO2_A x + ISO2_B over Fp2,
# Z = -(2 + i)
ISO2_A = (0, 240)
ISO2_B = (1012, 1012)
ISO2_Z = (P - 2, P - 1)
# normalized 3-isogeny E2' -> y^2 = x^3 + ISO2_BCOD (= 4(1+i) * 3^6),
# rescaled onto y^2 = x^3 + 4(1+i) by ISO2_C / ISO2_S3 (both in Fp)
ISO2_BCOD = (0xB64, 0xB64)
ISO2_C = (0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0)
ISO2_S3 = (0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0)
ISO2_N = (
    (0x130, 0x130),
    (0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA93),
    (0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
    (1, 0),
)
ISO2_D = (
    (0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
    (0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
    (1, 0),
)
# G2 effective cofactor (RFC 9380 8.8.2, Budroni-Pintore)
H_EFF_G2 = int(
    "bc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe13"
    "29c2f178731db956d82bf015d1212b02ec0ec69d7477c1ae954cbc06689f6a35"
    "9894c0adebbf6b4e8020005aaa95551", 16)


def _fp_sqrt(a: int) -> int | None:
    """Principal square root in Fp (p = 3 mod 4), or None."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def _fp2_sqrt(a) -> tuple | None:
    """Square root in Fp2 (complex method for p = 3 mod 4), or None.
    The final squaring check makes the algorithm self-verifying."""
    if a == (0, 0):
        return (0, 0)
    a1 = _fp2_pow(a, (P - 3) // 4)
    x0 = _fp2_mul(a1, a)
    alpha = _fp2_mul(a1, x0)
    if alpha == ((P - 1) % P, 0):
        x = _fp2_mul((0, 1), x0)
    else:
        b = _fp2_pow(_fp2_add((1, 0), alpha), (P - 1) // 2)
        x = _fp2_mul(b, x0)
    return x if _fp2_mul(x, x) == a else None


def _fp2_pow(a, e: int):
    r = (1, 0)
    while e:
        if e & 1:
            r = _fp2_mul(r, a)
        a = _fp2_mul(a, a)
        e >>= 1
    return r


def _sgn0_fp(x: int) -> int:
    return x % 2


def _sgn0_fp2(x) -> int:
    """RFC 9380 sgn0 for m=2: sign of x0, falling back to x1 when x0=0."""
    return x[0] % 2 if x[0] != 0 else x[1] % 2


def _sswu(u, A, B, Z, *, add, sub, mul, inv, sqrt, sgn0, neg, zero, one):
    """RFC 9380 6.6.2 simplified SWU: field element -> point on the
    isogenous curve y^2 = x^3 + Ax + B (never infinity)."""
    uu = mul(u, u)
    tv1 = add(mul(mul(mul(Z, Z), uu), uu), mul(Z, uu))
    if tv1 == zero:
        x = mul(B, inv(mul(Z, A)))
    else:
        x = mul(mul(neg(B), inv(A)), add(one, inv(tv1)))
    gx = add(add(mul(mul(x, x), x), mul(A, x)), B)
    y = sqrt(gx)
    if y is None:
        x = mul(mul(Z, uu), x)
        gx = add(add(mul(mul(x, x), x), mul(A, x)), B)
        y = sqrt(gx)
        # gx1 * gx2 = Z^3 u^6 gx1^2: with Z a non-square exactly one of
        # the two candidates is square, so this sqrt cannot fail
    if sgn0(u) != sgn0(y):
        y = neg(y)
    return x, y


def _poly_eval(coeffs, x, *, add, mul, zero):
    r = zero
    for c in reversed(coeffs):
        r = add(mul(r, x), c)
    return r


def _iso_map(pt, N, D, c, s3, *, add, sub, mul, inv, zero, int_):
    """Apply the normalized isogeny x -> N(x)/D(x), y -> y (N'D - ND')/D^2
    then rescale onto the BLS curve model (x *= c, y *= s3). A zero
    denominator means the input sits over the isogeny kernel -> infinity."""
    x, y = pt
    dv = _poly_eval(D, x, add=add, mul=mul, zero=zero)
    if dv == zero:
        return None
    nv = _poly_eval(N, x, add=add, mul=mul, zero=zero)
    ndiff = [mul(int_(i), co) for i, co in enumerate(N)][1:]
    ddiff = [mul(int_(i), co) for i, co in enumerate(D)][1:]
    w = sub(mul(_poly_eval(ndiff, x, add=add, mul=mul, zero=zero), dv),
            mul(nv, _poly_eval(ddiff, x, add=add, mul=mul, zero=zero)))
    xe = mul(mul(c, nv), inv(dv))
    ye = mul(mul(mul(y, s3), w), inv(mul(dv, dv)))
    return xe, ye


def _g1_map_ops():
    return dict(add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
                mul=lambda a, b: (a * b) % P, inv=_fp_inv, sqrt=_fp_sqrt,
                sgn0=_sgn0_fp, neg=lambda a: (-a) % P, zero=0, one=1)


def _g2_map_ops():
    return dict(add=_fp2_add, sub=_fp2_sub, mul=_fp2_mul, inv=_fp2_inv,
                sqrt=_fp2_sqrt, sgn0=_sgn0_fp2,
                neg=lambda a: ((-a[0]) % P, (-a[1]) % P),
                zero=(0, 0), one=(1, 0))


def map_fp_to_g1(u: int):
    """RFC 9380 map_to_curve + clear_cofactor for G1: Fp element ->
    point in the G1 subgroup (affine, None = infinity)."""
    ops = _g1_map_ops()
    pt = _sswu(u, ISO1_A, ISO1_B, ISO1_Z, **ops)
    pt = _iso_map(pt, ISO1_N, ISO1_D, ISO1_C, ISO1_S3,
                  add=ops["add"], sub=ops["sub"], mul=ops["mul"],
                  inv=ops["inv"], zero=0, int_=lambda k: k % P)
    return _mul_scalar(pt, H_EFF_G1, g1_add)


def map_fp2_to_g2(u):
    """RFC 9380 map_to_curve + clear_cofactor for G2: Fp2 element ->
    point in the G2 subgroup (affine, None = infinity)."""
    ops = _g2_map_ops()
    pt = _sswu(u, ISO2_A, ISO2_B, ISO2_Z, **ops)
    pt = _iso_map(pt, ISO2_N, ISO2_D, ISO2_C, ISO2_S3,
                  add=ops["add"], sub=ops["sub"], mul=ops["mul"],
                  inv=ops["inv"], zero=(0, 0), int_=lambda k: (k % P, 0))
    return _mul_scalar(pt, H_EFF_G2, g2_add)


def map_fp_to_g1_precompile(data: bytes) -> bytes:
    """EIP-2537 MAP_FP_TO_G1: one 64-byte padded Fp element -> G1 point."""
    if len(data) != 64:
        raise BlsError(
            f"MAP_FP_TO_G1 input must be 64 bytes, got {len(data)}")
    return encode_g1(map_fp_to_g1(_fp_decode(data)))


def map_fp2_to_g2_precompile(data: bytes) -> bytes:
    """EIP-2537 MAP_FP2_TO_G2: one 128-byte Fp2 element (c0 || c1) ->
    G2 point."""
    if len(data) != 128:
        raise BlsError(
            f"MAP_FP2_TO_G2 input must be 128 bytes, got {len(data)}")
    u = (_fp_decode(data[:64]), _fp_decode(data[64:]))
    return encode_g2(map_fp2_to_g2(u))
