"""Write-authorization JWTs, wire-compatible with the reference.

A copy of seaweedfs_tpu/security/jwt.py.

Reference: weed/security/jwt.go:30-89 — the master signs an
HS256 JWT over the assigned fid (claim "fid", optional "exp"); the volume
server rejects writes/deletes whose token is missing, expired, mis-signed,
or signed for a different fid (volume_server_handlers.go:145-187).  The
token travels in the `Authorization: Bearer` header or a `?jwt=` query
parameter (jwt.go GetJwt).

HS256 is hmac-sha256 over base64url segments — implemented on the stdlib so
no external JWT dependency is needed.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: str) -> bytes:
    pad = (-len(data)) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


_HEADER = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())


def encode_jwt(signing_key: str | bytes, claims: dict) -> str:
    """claims dict -> signed compact JWT string."""
    key = signing_key.encode() if isinstance(signing_key, str) else signing_key
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = _HEADER + b"." + payload
    sig = _b64url(hmac.new(key, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def decode_jwt(signing_key: str | bytes, token: str) -> dict:
    """Verify signature and expiry; return the claims dict."""
    key = signing_key.encode() if isinstance(signing_key, str) else signing_key
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    signing_input = (parts[0] + "." + parts[1]).encode()
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        sig = _b64url_decode(parts[2])
    except (ValueError, json.JSONDecodeError) as e:
        raise JwtError(f"malformed token: {e}")
    if header.get("alg") != "HS256":
        raise JwtError(f"unexpected alg {header.get('alg')!r}")
    want = hmac.new(key, signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(sig, want):
        raise JwtError("bad signature")
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise JwtError("token expired")
    return claims


def gen_volume_write_jwt(
    signing_key: str, fid: str, expires_after_sec: int = 10
) -> str:
    """Master-side: sign a write token for one assigned fid
    (GenJwtForVolumeServer jwt.go:30-50).  Empty key -> empty token."""
    if not signing_key:
        return ""
    claims: dict = {"fid": fid}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return encode_jwt(signing_key, claims)


def jwt_from_request(request) -> str:
    """Extract the token from ?jwt= or `Authorization: Bearer ...`
    (jwt.go GetJwt)."""
    token = request.query.get("jwt", "")
    if not token:
        bearer = request.headers.get("Authorization", "")
        if len(bearer) > 7 and bearer[:7].upper() == "BEARER ":
            token = bearer[7:]
    return token


def verify_volume_write_jwt(signing_key: str, request, fid: str) -> bool:
    """Volume-server-side write guard (volume_server_handlers.go:145-187):
    token must verify and its fid claim must match the request's fid with
    any `_N` batch suffix stripped.  No signing key configured -> open."""
    if not signing_key:
        return True
    token = jwt_from_request(request)
    if not token:
        return False
    try:
        claims = decode_jwt(signing_key, token)
    except JwtError:
        return False
    sep = fid.rfind("_")
    if sep > 0:
        fid = fid[:sep]
    return claims.get("fid") == fid
