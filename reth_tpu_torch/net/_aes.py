"""AES for the networking stack, on the port's own C++ (``csrc/aes.cpp``).

RLPx framing, the ECIES handshake and discv5's packets need AES in CTR, ECB
and GCM. The JAX package takes them from the third-party ``cryptography``
package through a shim that fails at first use where it is missing; the
port builds its own AES with g++ (``ops/_build.py``) at first use and loads
it with ctypes, and never imports ``cryptography``. A failed build raises
:class:`~reth_tpu_torch.ops._build.BuildError`: there is no other
implementation to fall to.

The surface is the part of ``cryptography``'s that ``ecies.py``,
``rlpx.py`` and ``discv5.py`` call, so those modules are the reference's:
``Cipher(algorithms.AES(key), modes.CTR(iv) | modes.ECB())`` with
``encryptor()`` (and, for CTR, ``decryptor()``; ``update``, ``finalize``) and
``AESGCM(key).encrypt / decrypt(nonce, data, aad)``, which raises
:class:`InvalidTag` on a forged or corrupted message.
"""

from __future__ import annotations

import ctypes
import threading

_lib = None
_lock = threading.Lock()


def _load():
    """The ctypes handle of ``csrc/aes.cpp``, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from ..ops._build import PKG_DIR, load

            lib = load(PKG_DIR / "csrc" / "aes.cpp")
            u8p = ctypes.c_char_p
            lib.rtaes_expand.argtypes = [u8p, ctypes.c_int, u8p]
            lib.rtaes_expand.restype = ctypes.c_int
            lib.rtaes_ecb.argtypes = [u8p, ctypes.c_int, u8p, u8p, ctypes.c_uint64]
            lib.rtaes_ecb.restype = None
            lib.rtaes_ctr.argtypes = [u8p, ctypes.c_int, u8p, u8p,
                                      ctypes.POINTER(ctypes.c_uint32), u8p, u8p,
                                      ctypes.c_uint64]
            lib.rtaes_ctr.restype = None
            lib.rtaes_gcm.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_uint64,
                                      u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, u8p, u8p]
            lib.rtaes_gcm.restype = ctypes.c_int
            _lib = lib
    return _lib


class InvalidTag(Exception):
    """An AES-GCM message whose tag does not verify."""


def _schedule(key: bytes) -> tuple[ctypes.Array, int]:
    key = bytes(key)
    if len(key) not in (16, 24, 32):
        raise ValueError(f"Invalid key size ({8 * len(key)}) for AES.")
    rk = ctypes.create_string_buffer(240)
    nr = _load().rtaes_expand(key, len(key), rk)
    return rk, nr


class _AES:
    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError(f"Invalid key size ({8 * len(key)}) for AES.")
        self.key = bytes(key)


class _CTR:
    def __init__(self, nonce: bytes):
        if len(nonce) != 16:
            raise ValueError(f"Invalid nonce size ({len(nonce)}) for CTR.")
        self.nonce = bytes(nonce)


class _ECB:
    pass


class algorithms:  # noqa: N801 - the name ``cryptography`` gives it
    AES = _AES


class modes:  # noqa: N801
    CTR = _CTR
    ECB = _ECB


class _CtrContext:
    """A CTR stream: consecutive ``update`` calls continue one keystream."""

    def __init__(self, key: bytes, nonce: bytes):
        self._rk, self._nr = _schedule(key)
        self._ctr = ctypes.create_string_buffer(bytes(nonce), 16)
        self._ks = ctypes.create_string_buffer(16)
        self._used = ctypes.c_uint32(16)

    def update(self, data: bytes) -> bytes:
        data = bytes(data)
        out = ctypes.create_string_buffer(len(data))
        _load().rtaes_ctr(self._rk, self._nr, self._ctr, self._ks, ctypes.byref(self._used),
                          data, out, len(data))
        return out.raw

    def finalize(self) -> bytes:
        return b""


class _EcbContext:
    """ECB encryption (the RLPx MAC's one-block seal)."""

    def __init__(self, key: bytes):
        self._rk, self._nr = _schedule(key)
        self._buf = b""

    def update(self, data: bytes) -> bytes:
        buf = self._buf + bytes(data)
        whole = len(buf) - len(buf) % 16
        self._buf = buf[whole:]
        if not whole:
            return b""
        out = ctypes.create_string_buffer(whole)
        _load().rtaes_ecb(self._rk, self._nr, buf[:whole], out, whole // 16)
        return out.raw

    def finalize(self) -> bytes:
        if self._buf:
            raise ValueError("The length of the provided data is not a multiple of the "
                             "block length.")
        return b""


class Cipher:
    def __init__(self, algorithm: _AES, mode):
        if not isinstance(algorithm, _AES):
            raise TypeError("only AES is provided")
        if not isinstance(mode, (_CTR, _ECB)):
            raise TypeError("only CTR and ECB are provided")
        self.algorithm, self.mode = algorithm, mode

    def encryptor(self):
        if isinstance(self.mode, _CTR):
            return _CtrContext(self.algorithm.key, self.mode.nonce)
        return _EcbContext(self.algorithm.key)

    def decryptor(self):
        """CTR only: its decryption is its encryption. No caller decrypts
        ECB, so the inverse cipher is not built."""
        if not isinstance(self.mode, _CTR):
            raise ValueError("ECB decryption is not provided")
        return _CtrContext(self.algorithm.key, self.mode.nonce)


class AESGCM:
    """AES-GCM with a 16-byte tag appended to the ciphertext."""

    def __init__(self, key: bytes):
        self._rk, self._nr = _schedule(key)

    @staticmethod
    def _check_nonce(nonce: bytes) -> bytes:
        nonce = bytes(nonce)
        if not 8 <= len(nonce) <= 128:
            raise ValueError("Nonce must be between 8 and 128 bytes")
        return nonce

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        nonce, data = self._check_nonce(nonce), bytes(data)
        aad = bytes(associated_data or b"")
        out = ctypes.create_string_buffer(len(data))
        tag = ctypes.create_string_buffer(16)
        _load().rtaes_gcm(self._rk, self._nr, 0, nonce, len(nonce), aad, len(aad), data,
                          len(data), out, tag)
        return out.raw + tag.raw

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        nonce, data = self._check_nonce(nonce), bytes(data)
        if len(data) < 16:
            raise InvalidTag()
        aad = bytes(associated_data or b"")
        body, tag = data[:-16], data[-16:]
        out = ctypes.create_string_buffer(len(body))
        if _load().rtaes_gcm(self._rk, self._nr, 1, nonce, len(nonce), aad, len(aad), body,
                             len(body), out, tag):
            raise InvalidTag()
        return out.raw
