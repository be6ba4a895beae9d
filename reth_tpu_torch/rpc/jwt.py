"""HS256 JWT for the Engine API auth port.

A copy of the JAX package's ``rpc/jwt.py``.

Reference analogue: the JWT auth layer on the reference's engine server
(crates/rpc/rpc-layer/src/auth_layer.rs): the consensus client signs
every request with a token over the shared 32-byte hex secret; `iat`
must be within +-60 s of now (IAT_WINDOW). Stdlib-only (hmac + base64).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

IAT_WINDOW = 60  # seconds of clock drift tolerated


class JwtError(ValueError):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def encode_jwt(secret: bytes, claims: dict | None = None) -> str:
    """Token the CL side would send (used by tests and the debug client)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps({"iat": int(time.time()), **(claims or {})}).encode())
    signing_input = header + b"." + payload
    sig = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def validate_jwt(secret: bytes, token: str) -> dict:
    """Verify signature + iat window; returns the claims. Raises JwtError."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    signing_input = (parts[0] + "." + parts[1]).encode()
    want = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
    if not hmac.compare_digest(want.decode(), parts[2]):
        raise JwtError("signature mismatch")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
    except (ValueError, UnicodeDecodeError) as e:
        raise JwtError("undecodable token") from e
    if header.get("alg") != "HS256":
        raise JwtError(f"unsupported alg {header.get('alg')}")
    iat = claims.get("iat")
    if not isinstance(iat, int) or abs(time.time() - iat) > IAT_WINDOW:
        raise JwtError("iat outside the allowed window")
    return claims


def load_or_create_secret(path) -> bytes:
    """Read a 32-byte hex secret file, creating one when absent (the
    reference generates jwt.hex on first launch)."""
    from pathlib import Path

    p = Path(path)
    if p.exists():
        text = p.read_text().strip().removeprefix("0x")
        secret = bytes.fromhex(text)
        if len(secret) != 32:
            raise JwtError(f"jwt secret in {p} must be 32 bytes")
        return secret
    secret = os.urandom(32)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:  # owner-only: the secret mints engine auth
        f.write(secret.hex() + "\n")
    return secret
