"""Chunk compression: zstd (preferred, native libzstd via the zstandard
C extension) with gzip read-compat.  A copy of
seaweedfs_tpu/utils/compression.py.  The machine with the card has no
`zstandard`: there `compress` writes gzip, as the reference's does
without it, and `decompress` still reads a gzip frame (a zstd frame needs
the package).

Reference: weed/util/compression.go — MaybeGzipData/DecompressData with
IsGzippableFileType gating by mime/extension; the reference also links
klauspost's native zstd.  Wire format is self-describing via magic bytes
(zstd: 28 B5 2F FD, gzip: 1F 8B), so decompress() handles either.
"""
from __future__ import annotations

import gzip

try:
    import zstandard as _zstd

    _ZC = _zstd.ZstdCompressor(level=3)
    _ZD = _zstd.ZstdDecompressor()
except ImportError:  # the card's machine: gzip frames only
    _zstd = None

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
GZIP_MAGIC = b"\x1f\x8b"

_COMPRESSIBLE_EXT = {
    ".txt", ".htm", ".html", ".css", ".js", ".json", ".xml", ".csv",
    ".svg", ".md", ".log", ".conf", ".yaml", ".yml", ".toml", ".bin",
    ".dat", ".pdf",
}
_INCOMPRESSIBLE_MIME_PREFIX = ("image/", "video/", "audio/")
_INCOMPRESSIBLE_MIME = {
    "application/zip", "application/gzip", "application/x-gzip",
    "application/zstd", "application/x-xz", "application/x-bzip2",
    "application/x-7z-compressed", "application/x-rar-compressed",
}


def is_compressible(mime: str = "", ext: str = "") -> bool:
    """Gate by content type (util/compression.go IsGzippableFileType)."""
    mime = (mime or "").split(";")[0].strip().lower()
    if mime:
        if mime in _INCOMPRESSIBLE_MIME:
            return False
        if mime.startswith(_INCOMPRESSIBLE_MIME_PREFIX):
            return False
        if mime.startswith("text/") or mime.endswith(("+json", "+xml")):
            return True
        if mime in ("application/json", "application/xml", "application/javascript"):
            return True
    if ext:
        return ext.lower() in _COMPRESSIBLE_EXT
    return bool(mime)


def compress(data: bytes) -> bytes:
    """zstd when available, else gzip."""
    if _zstd is not None:
        return _ZC.compress(data)
    return gzip.compress(data)


def maybe_compress(data: bytes, mime: str = "", ext: str = "") -> tuple[bytes, bool]:
    """Compress when the type gates allow and it actually shrinks the
    payload (MaybeGzipData's 'only keep if smaller' rule)."""
    if len(data) < 128 or not is_compressible(mime, ext):
        return data, False
    packed = compress(data)
    if len(packed) >= len(data):
        return data, False
    return packed, True


def decompress(data: bytes) -> bytes:
    """Self-detect zstd or gzip by magic; raise on unknown framing."""
    if data[:4] == ZSTD_MAGIC:
        if _zstd is None:
            raise RuntimeError("zstd frame but zstandard not available")
        return _ZD.decompress(data)
    if data[:2] == GZIP_MAGIC:
        return gzip.decompress(data)
    raise ValueError("unknown compression framing")
