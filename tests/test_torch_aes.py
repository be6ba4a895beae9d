"""The port's AES (csrc/aes.cpp through net/_aes.py), which RLPx framing, the
ECIES handshake and discv5 run on in place of the ``cryptography`` package.

Held to the specification vectors typed in below: FIPS-197 Appendix C (the
block cipher at 128, 192 and 256 bits), NIST SP 800-38A F.1.1
(ECB) and F.5.1 / F.5.5 (CTR), and the GCM specification's test cases 1-6
and 16 (McGrew and Viega; 96-bit, 64-bit and 480-bit IVs, with and without
associated data). Where ``cryptography`` is installed, random keys, IVs and
lengths are also compared against it; the port itself never imports it.
"""

from __future__ import annotations

import random

import pytest

from reth_tpu_torch.net import _aes

H = bytes.fromhex


def _ecb(key: bytes, data: bytes) -> bytes:
    ctx = _aes.Cipher(_aes.algorithms.AES(key), _aes.modes.ECB()).encryptor()
    return ctx.update(data) + ctx.finalize()


FIPS197 = [  # Appendix C: key, plaintext, ciphertext
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f1011121314151617", "00112233445566778899aabbccddeeff",
     "dda97ca4864cdfe06eaf70a0ec0d7191"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "00112233445566778899aabbccddeeff", "8ea2b7ca516745bfeafc49904b496089"),
]


@pytest.mark.parametrize("key,pt,ct", FIPS197, ids=["aes128", "aes192", "aes256"])
def test_fips197_appendix_c(key, pt, ct):
    assert _ecb(H(key), H(pt)) == H(ct)


SP800_38A_PT = H("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                 "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
KEY128 = H("2b7e151628aed2a6abf7158809cf4f3c")
KEY256 = H("603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4")
COUNTER = H("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")


def test_sp800_38a_ecb_aes128():
    ct = H("3ad77bb40d7a3660a89ecaf32466ef97f5d3d58503b9699de785895a96fdbaaf"
           "43b1cd7f598ece23881b00e3ed0306887b0c785e27e8ad3f8223207104725dd4")
    assert _ecb(KEY128, SP800_38A_PT) == ct
    with pytest.raises(ValueError):  # no caller decrypts ECB
        _aes.Cipher(_aes.algorithms.AES(KEY128), _aes.modes.ECB()).decryptor()
    enc = _aes.Cipher(_aes.algorithms.AES(KEY128), _aes.modes.ECB()).encryptor()
    assert enc.update(SP800_38A_PT[:7]) == b""  # partial blocks wait for the rest
    assert enc.update(SP800_38A_PT[7:32]) == ct[:32]
    with pytest.raises(ValueError):
        enc.update(b"x")
        enc.finalize()


@pytest.mark.parametrize("key,ct", [
    (KEY128, "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
             "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee"),
    (KEY256, "601ec313775789a5b7a7f504bbf3d228f443e3ca4d62b59aca84e990cacaf5c5"
             "2b0930daa23de94ce87017ba2d84988ddfc9c58db67aada613c2dd08457941a6"),
], ids=["f5.1-aes128", "f5.5-aes256"])
def test_sp800_38a_ctr(key, ct):
    c = _aes.Cipher(_aes.algorithms.AES(key), _aes.modes.CTR(COUNTER))
    assert c.encryptor().update(SP800_38A_PT) == H(ct)
    dec = c.decryptor()  # a stream: odd-sized updates continue one keystream
    got = b"".join(dec.update(H(ct)[a:b]) for a, b in ((0, 5), (5, 16), (16, 17), (17, 64)))
    assert got + dec.finalize() == SP800_38A_PT


def test_ctr_counter_wraps_all_128_bits():
    key = bytes(range(16))
    top = b"\xff" * 16
    ks = _aes.Cipher(_aes.algorithms.AES(key), _aes.modes.CTR(top)).encryptor().update(
        bytes(48))
    assert ks[:16] == _ecb(key, top)
    assert ks[16:32] == _ecb(key, bytes(16))
    assert ks[32:] == _ecb(key, bytes(15) + b"\x01")


K3 = "feffe9928665731c6d6a8f9467308308"
P3 = ("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
      "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
P4 = P3[:120]
A4 = "feedfacedeadbeeffeedfacedeadbeefabaddad2"
GCM = [  # (key, iv, plaintext, aad, ciphertext, tag)
    ("00" * 16, "00" * 12, "", "", "", "58e2fccefa7e3061367f1d57a4e7455a"),
    ("00" * 16, "00" * 12, "00" * 16, "", "0388dace60b6a392f328c2b971b2fe78",
     "ab6e47d42cec13bdf53a67b21257bddf"),
    (K3, "cafebabefacedbaddecaf888", P3, "",
     "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
     "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985",
     "4d5c2af327cd64a62cf35abd2ba6fab4"),
    (K3, "cafebabefacedbaddecaf888", P4, A4,
     "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
     "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091",
     "5bc94fbc3221a5db94fae95ae7121a47"),
    (K3, "cafebabefacedbad", P4, A4,
     "61353b4c2806934a777ff51fa22a4755699b2a714fcdc6f83766e5f97b6c7423"
     "73806900e49f24b22b097544d4896b424989b5e1ebac0f07c23f4598",
     "3612d2e79e3b0785561be14aaca2fccb"),
    (K3, "9313225df88406e555909c5aff5269aa6a7a9538534f7da1e4c303d2a318a728"
         "c3c0c95156809539fcf0e2429a6b525416aedbf5a0de6a57a637b39b", P4, A4,
     "8ce24998625615b603a033aca13fb894be9112a5c3a211a8ba262a3cca7e2ca7"
     "01e4a9a4fba43c90ccdcb281d48c7c6fd62875d2aca417034c34aee5",
     "619cc5aefffe0bfa462af43c1699d050"),
    (K3 * 2, "cafebabefacedbaddecaf888", P4, A4,
     "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
     "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662",
     "76fc6ece0f4e1768cddf8853bb2d551b"),
]


@pytest.mark.parametrize("key,iv,pt,aad,ct,tag", GCM,
                         ids=["tc1", "tc2", "tc3", "tc4", "tc5-iv64", "tc6-iv480",
                              "tc16-aes256"])
def test_gcm_specification_vectors(key, iv, pt, aad, ct, tag):
    g = _aes.AESGCM(H(key))
    assert g.encrypt(H(iv), H(pt), H(aad) or None) == H(ct + tag)
    assert g.decrypt(H(iv), H(ct + tag), H(aad) or None) == H(pt)
    for flip in range(0, len(H(ct + tag)), 7):
        bad = bytearray(H(ct + tag))
        bad[flip] ^= 0x40
        with pytest.raises(_aes.InvalidTag):
            g.decrypt(H(iv), bytes(bad), H(aad) or None)
    with pytest.raises(_aes.InvalidTag):
        g.decrypt(H(iv), H(ct + tag), H(aad) + b"\x00")


def test_bad_sizes_raise():
    for n in (0, 15, 17, 33):
        with pytest.raises(ValueError):
            _aes.algorithms.AES(bytes(n))
        with pytest.raises(ValueError):
            _aes.AESGCM(bytes(n))
    with pytest.raises(ValueError):
        _aes.modes.CTR(bytes(12))
    with pytest.raises(ValueError):
        _aes.AESGCM(bytes(16)).encrypt(bytes(4), b"x", None)
    with pytest.raises(_aes.InvalidTag):
        _aes.AESGCM(bytes(16)).decrypt(bytes(12), bytes(15), None)


def test_random_against_cryptography():
    """Random keys, IVs, lengths and split points against OpenSSL's AES."""
    crypto = pytest.importorskip("cryptography.hazmat.primitives.ciphers")
    aead = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    rng = random.Random(18)
    rb = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    for _ in range(150):
        key, iv = rb(rng.choice((16, 24, 32))), rb(16)
        data = rb(rng.randrange(0, 400))
        cut = rng.randrange(len(data) + 1)
        want = crypto.Cipher(crypto.algorithms.AES(key), crypto.modes.CTR(iv)).encryptor()
        got = _aes.Cipher(_aes.algorithms.AES(key), _aes.modes.CTR(iv)).encryptor()
        assert got.update(data[:cut]) + got.update(data[cut:]) == \
            want.update(data[:cut]) + want.update(data[cut:])
        blocks = rb(16 * rng.randrange(1, 6))
        assert _ecb(key, blocks) == crypto.Cipher(crypto.algorithms.AES(key),
                                                  crypto.modes.ECB()).encryptor().update(blocks)
        nonce, aad = rb(rng.choice((12, 12, 8, 16, 40))), rb(rng.randrange(0, 50))
        ct = aead.AESGCM(key).encrypt(nonce, data, aad)
        assert _aes.AESGCM(key).encrypt(nonce, data, aad) == ct
        assert _aes.AESGCM(key).decrypt(nonce, ct, aad) == data
