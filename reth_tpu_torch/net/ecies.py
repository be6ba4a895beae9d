"""ECIES transport encryption + the RLPx EIP-8 auth/ack handshake.

Reference analogue: crates/net/ecies/src/algorithm.rs — the encrypted
channel every devp2p session starts with. Scheme (devp2p spec):

- ECIES encrypt(recipient-pubkey, msg): ephemeral key e; shared x =
  ecdh(e, recipient); kE||kM = NIST-SP-800-56 concat-KDF(x, 32);
  AES-128-CTR(kE, random iv) over msg; tag = HMAC-SHA256(sha256(kM),
  iv || ciphertext || shared-mac-data). Wire form:
  0x04||ephemeral-pub(64) || iv(16) || ciphertext || tag(32).
- EIP-8 handshake: auth = 2-byte size prefix ++ ECIES over RLP
  [sig(65), initiator-pubkey(64), nonce(32), vsn=4] (the size prefix is
  the HMAC's shared-mac-data); sig = ecdsa(ephemeral-priv is RECOVERED
  by the peer from: sign(static-shared-x XOR initiator-nonce) with the
  initiator's EPHEMERAL key). ack = same framing over RLP
  [recipient-ephemeral-pubkey(64), nonce(32), vsn=4].

AES comes from the port's own `csrc/aes.cpp` (net/_aes.py); everything
else is the port's own secp256k1/keccak/RLP primitives. A copy of the JAX
package's module.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import struct

from ..primitives import secp256k1
from ..primitives.rlp import rlp_decode_prefix, rlp_encode
from ..primitives.secp256k1 import (
    ecdh_x,
    pubkey_from_bytes,
    pubkey_from_priv,
    pubkey_to_bytes,
    random_priv,
)
from ._aes import Cipher, algorithms, modes  # the port's AES, csrc/aes.cpp

AUTH_VSN = 4


class EciesError(ValueError):
    pass


def _kdf(secret: bytes, length: int) -> bytes:
    """NIST SP 800-56 concatenation KDF over SHA-256."""
    out = b""
    counter = 1
    while len(out) < length:
        out += hashlib.sha256(struct.pack(">I", counter) + secret).digest()
        counter += 1
    return out[:length]


def _aes_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    c = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return c.update(data) + c.finalize()


def encrypt(recipient_pub: tuple[int, int], msg: bytes,
            shared_mac_data: bytes = b"") -> bytes:
    eph_priv = random_priv()
    shared = ecdh_x(eph_priv, recipient_pub)
    keys = _kdf(shared, 32)
    ke, km = keys[:16], hashlib.sha256(keys[16:]).digest()
    iv = os.urandom(16)
    ct = _aes_ctr(ke, iv, msg)
    tag = hmac_mod.new(km, iv + ct + shared_mac_data, hashlib.sha256).digest()
    return b"\x04" + pubkey_to_bytes(pubkey_from_priv(eph_priv)) + iv + ct + tag


def decrypt(priv: int, data: bytes, shared_mac_data: bytes = b"") -> bytes:
    if len(data) < 1 + 64 + 16 + 32 or data[0] != 0x04:
        raise EciesError("malformed ECIES envelope")
    eph_pub = pubkey_from_bytes(data[1:65])
    iv = data[65:81]
    ct = data[81:-32]
    tag = data[-32:]
    keys = _kdf(ecdh_x(priv, eph_pub), 32)
    ke, km = keys[:16], hashlib.sha256(keys[16:]).digest()
    want = hmac_mod.new(km, iv + ct + shared_mac_data, hashlib.sha256).digest()
    if not hmac_mod.compare_digest(tag, want):
        raise EciesError("ECIES MAC mismatch")
    return _aes_ctr(ke, iv, ct)


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _eip8_wrap(recipient_pub, payload_fields: list) -> bytes:
    """EIP-8 envelope: random pad, 2-byte size prefix as MAC data."""
    plain = rlp_encode(payload_fields) + os.urandom(100 + os.urandom(1)[0] % 100)
    # size = ECIES overhead (113) + plaintext
    size = struct.pack(">H", len(plain) + 113)
    return size + encrypt(recipient_pub, plain, shared_mac_data=size)


def _eip8_unwrap(priv: int, data: bytes) -> list:
    if len(data) < 2:
        raise EciesError("truncated handshake message")
    size = struct.unpack(">H", data[:2])[0]
    if len(data) - 2 != size:
        raise EciesError("handshake size prefix mismatch")
    plain = decrypt(priv, data[2:], shared_mac_data=data[:2])
    fields, _consumed = rlp_decode_prefix(plain)  # EIP-8: ignore padding
    return fields


class Handshake:
    """One side of the RLPx auth/ack exchange; produces the frame secrets.

    Usage (initiator):  h = Handshake(static_priv); auth = h.auth(peer_pub);
    secrets = h.finalize_initiator(ack_bytes).
    Usage (recipient):  h = Handshake(static_priv);
    ack, secrets = h.on_auth(auth_bytes).
    """

    def __init__(self, static_priv: int, eph_priv: int | None = None,
                 nonce: bytes | None = None):
        self.static_priv = static_priv
        self.eph_priv = eph_priv or random_priv()
        self.nonce = nonce or os.urandom(32)
        self._auth_bytes: bytes | None = None
        self._ack_bytes: bytes | None = None
        self.remote_pub: tuple[int, int] | None = None

    # -- initiator ----------------------------------------------------------

    def auth(self, recipient_pub: tuple[int, int]) -> bytes:
        self.remote_pub = recipient_pub
        token = ecdh_x(self.static_priv, recipient_pub)
        digest = _xor(token, self.nonce)
        y, r, s = secp256k1.sign(digest, self.eph_priv)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([y])
        fields = [sig, pubkey_to_bytes(pubkey_from_priv(self.static_priv)),
                  self.nonce, bytes([AUTH_VSN])]
        self._auth_bytes = _eip8_wrap(recipient_pub, fields)
        return self._auth_bytes

    def finalize_initiator(self, ack_bytes: bytes) -> "FrameSecrets":
        f = _eip8_unwrap(self.static_priv, ack_bytes)
        remote_eph = pubkey_from_bytes(f[0])
        remote_nonce = f[1]
        self._ack_bytes = ack_bytes
        eph_shared = ecdh_x(self.eph_priv, remote_eph)
        return derive_secrets(
            eph_shared, self.nonce, remote_nonce,
            self._auth_bytes, ack_bytes, initiator=True,
        )

    # -- recipient ----------------------------------------------------------

    def on_auth(self, auth_bytes: bytes) -> tuple[bytes, "FrameSecrets"]:
        f = _eip8_unwrap(self.static_priv, auth_bytes)
        sig, initiator_pub_raw, init_nonce = f[0], f[1], f[2]
        initiator_pub = pubkey_from_bytes(initiator_pub_raw)
        self.remote_pub = initiator_pub
        token = ecdh_x(self.static_priv, initiator_pub)
        digest = _xor(token, init_nonce)
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        remote_eph_raw = secp256k1.ecrecover(
            digest, sig[64], r, s, allow_high_s=True, return_pubkey=True
        )
        remote_eph = pubkey_from_bytes(remote_eph_raw)
        fields = [pubkey_to_bytes(pubkey_from_priv(self.eph_priv)),
                  self.nonce, bytes([AUTH_VSN])]
        ack = _eip8_wrap(initiator_pub, fields)
        eph_shared = ecdh_x(self.eph_priv, remote_eph)
        secrets = derive_secrets(
            eph_shared, init_nonce, self.nonce, auth_bytes, ack, initiator=False,
        )
        return ack, secrets


class FrameSecrets:
    """aes/mac secrets + seeded egress/ingress MAC states (net/rlpx.py)."""

    def __init__(self, aes: bytes, mac: bytes, egress_seed: bytes,
                 ingress_seed: bytes):
        from ..primitives.keccak import Keccak256

        self.aes = aes
        self.mac = mac
        self.egress_mac = Keccak256(egress_seed)
        self.ingress_mac = Keccak256(ingress_seed)


def derive_secrets(eph_shared: bytes, init_nonce: bytes, resp_nonce: bytes,
                   auth_bytes: bytes, ack_bytes: bytes,
                   initiator: bool) -> FrameSecrets:
    """devp2p secret schedule (both sides derive identical aes/mac keys;
    the MAC seeds swap roles by direction)."""
    from ..primitives.keccak import keccak256

    shared = keccak256(eph_shared + keccak256(resp_nonce + init_nonce))
    aes = keccak256(eph_shared + shared)
    mac = keccak256(eph_shared + aes)
    seed_out = _xor(mac, resp_nonce) + auth_bytes
    seed_in = _xor(mac, init_nonce) + ack_bytes
    if not initiator:
        seed_out, seed_in = seed_in, seed_out
    return FrameSecrets(aes, mac, seed_out, seed_in)
