"""At-rest chunk encryption: AES-256-GCM, one random key per chunk.

A copy of seaweedfs_tpu/utils/cipher.py that imports `cryptography` only
where a chunk is encrypted or decrypted: the machine with the card has no
such package, and everything else of the filer runs without it.  A filer
started with `-encryptVolumeData` on such a machine exits at start
(`require`), where the reference's would fail on its first write.

Reference: weed/util/cipher.go (Encrypt/Decrypt with AES-GCM, random
nonce prepended to the ciphertext) — the per-chunk key travels in
FileChunk.cipher_key metadata, never alongside the data.
"""
from __future__ import annotations

import os

KEY_SIZE = 32
NONCE_SIZE = 12


def require() -> None:
    """Raise RuntimeError naming the package when it is missing."""
    try:
        import cryptography.hazmat.primitives.ciphers.aead  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "-encryptVolumeData needs the `cryptography` package "
            "(AES-256-GCM), which this machine does not have") from None


def _aesgcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return AESGCM(key)


def gen_cipher_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(data: bytes, key: bytes) -> bytes:
    """nonce || ciphertext+tag (cipher.go Encrypt layout)."""
    nonce = os.urandom(NONCE_SIZE)
    return nonce + _aesgcm(key).encrypt(nonce, data, None)


def decrypt(blob: bytes, key: bytes) -> bytes:
    if len(blob) < NONCE_SIZE:
        raise ValueError("cipher blob too short")
    return _aesgcm(key).decrypt(blob[:NONCE_SIZE], blob[NONCE_SIZE:], None)
