"""Needle codec — one stored object inside a volume file.

On-disk record (byte-compatible with the reference, all big-endian;
weed/storage/needle/needle.go:25-45, needle_write.go:20-113,
needle_read.go:110-196):

  header:  cookie u32 | needle_id u64 | size i32          (16 bytes)
  body v2+ (present when data non-empty; `size` counts exactly this):
    data_size u32 | data | flags u8
    [name_size u8 | name]        if FLAG_HAS_NAME
    [mime_size u8 | mime]        if FLAG_HAS_MIME
    [last_modified 5 bytes]      if FLAG_HAS_LAST_MODIFIED
    [ttl 2 bytes]                if FLAG_HAS_TTL
    [pairs_size u16 | pairs]     if FLAG_HAS_PAIRS
  footer:  checksum u32 (CRC32C of data)
           append_at_ns u64                                (version 3 only)
           zero padding to the next 8-byte boundary (always 1-8 bytes,
           matching PaddingLength's `8 - (x % 8)` quirk, needle_read.go:198-204)
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from ..ops.crc import crc32c
from . import types as t

VERSION1, VERSION2, VERSION3 = 1, 2, 3
CURRENT_VERSION = VERSION3

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5

_HDR = struct.Struct(">IQi")  # cookie, id, size


def mask_crc(c: int) -> int:
    """The deprecated CRC.Value() transform (rotl 17 + const) that legacy
    volumes stored on disk; reference weed/storage/needle/crc.go:25-27."""
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def padding_length(size: int, version: int) -> int:
    base = t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        base += t.TIMESTAMP_SIZE
    return t.NEEDLE_PADDING_SIZE - (base % t.NEEDLE_PADDING_SIZE)


def actual_size(size: int, version: int) -> int:
    """Total on-disk bytes of a record with body length `size`."""
    base = t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
    if version == VERSION3:
        base += t.TIMESTAMP_SIZE
    return base + padding_length(size, version)


@dataclass
class Needle:
    id: int = 0
    cookie: int = 0
    # memoryview only on the zero-copy serving parse (from_bytes
    # copy=False); everywhere else this is bytes
    data: bytes | memoryview = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0  # unix seconds
    ttl: t.TTL = field(default_factory=t.TTL)
    flags: int = 0
    checksum: int = 0
    append_at_ns: int = 0
    size: int = 0  # body size on disk (computed at encode)

    # -- flag helpers --------------------------------------------------------

    @property
    def is_compressed(self) -> bool:
        return bool(self.flags & FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def _effective_flags(self) -> int:
        f = self.flags
        if self.name:
            f |= FLAG_HAS_NAME
        if self.mime:
            f |= FLAG_HAS_MIME
        if self.last_modified:
            f |= FLAG_HAS_LAST_MODIFIED
        if self.ttl:
            f |= FLAG_HAS_TTL
        if self.pairs:
            f |= FLAG_HAS_PAIRS
        return f

    # -- encode --------------------------------------------------------------

    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """Serialize the full on-disk record (header..padding)."""
        self.checksum = crc32c(self.data)
        if version == VERSION1:
            self.size = len(self.data)
            out = bytearray(_HDR.pack(self.cookie, self.id, self.size))
            out += self.data
            out += struct.pack(">I", self.checksum)
            out += b"\x00" * padding_length(self.size, version)
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        flags = self._effective_flags()
        body = bytearray()
        if self.data:
            body += struct.pack(">I", len(self.data))
            body += self.data
            body += bytes([flags])
            if flags & FLAG_HAS_NAME:
                name = self.name[:255]
                body += bytes([len(name)]) + name
            if flags & FLAG_HAS_MIME:
                mime = self.mime[:255]
                body += bytes([len(mime)]) + mime
            if flags & FLAG_HAS_LAST_MODIFIED:
                body += struct.pack(">Q", self.last_modified)[
                    8 - LAST_MODIFIED_BYTES :
                ]
            if flags & FLAG_HAS_TTL:
                body += self.ttl.to_bytes()
            if flags & FLAG_HAS_PAIRS:
                body += struct.pack(">H", len(self.pairs)) + self.pairs
        self.flags = flags
        self.size = len(body)
        out = bytearray(_HDR.pack(self.cookie, self.id, self.size))
        out += body
        out += struct.pack(">I", self.checksum)
        if version == VERSION3:
            if not self.append_at_ns:
                self.append_at_ns = time.time_ns()
            out += struct.pack(">Q", self.append_at_ns)
        out += b"\x00" * padding_length(self.size, version)
        return bytes(out)

    # -- decode --------------------------------------------------------------

    @classmethod
    def parse_header(cls, buf: bytes) -> tuple[int, int, int]:
        """16-byte header -> (cookie, needle_id, size)."""
        return _HDR.unpack_from(buf)

    @classmethod
    def from_bytes(
        cls,
        buf: bytes | bytearray | memoryview,
        version: int = CURRENT_VERSION,
        verify: bool = True,
        copy: bool = True,
    ) -> "Needle":
        """Parse a full record produced by to_bytes (header..footer; padding
        may be absent or present).  `copy=False` keeps `data` a memoryview
        over `buf` (the zero-copy serving path: the reconstruct/needle
        buffer is streamed straight into the HTTP response without a
        bytes materialization) — the caller owns keeping `buf` alive and
        unmutated for the needle's lifetime.  Name/mime/pairs stay small
        bytes copies either way."""
        cookie, nid, size = _HDR.unpack_from(buf)
        n = cls(id=nid, cookie=cookie, size=size)
        if size < 0:  # tombstone record
            return n
        body = memoryview(buf)[t.NEEDLE_HEADER_SIZE : t.NEEDLE_HEADER_SIZE + size]
        if version == VERSION1:
            n.data = body if not copy else bytes(body)
        else:
            n._parse_body_v2(body, copy=copy)
        off = t.NEEDLE_HEADER_SIZE + size
        (n.checksum,) = struct.unpack_from(">I", buf, off)
        off += 4
        if version == VERSION3 and len(buf) >= off + 8:
            (n.append_at_ns,) = struct.unpack_from(">Q", buf, off)
        if verify:
            computed = crc32c(n.data)
            # Older volumes store the *masked* CRC (the deprecated
            # CRC.Value(), needle/crc.go:25-27); the read path accepts raw
            # or masked exactly like needle_read.go:74-78.
            if n.checksum not in (computed, mask_crc(computed)):
                raise CrcError(
                    f"needle {n.id:x} CRC mismatch: stored {n.checksum:08x} "
                    f"computed {computed:08x} (masked {mask_crc(computed):08x})"
                )
            n.checksum = computed
        return n

    def _parse_body_v2(
        self, body: bytes | memoryview, copy: bool = True
    ) -> None:
        if not body:
            return
        (data_size,) = struct.unpack_from(">I", body, 0)
        idx = 4
        payload = memoryview(body)[idx : idx + data_size]
        self.data = bytes(payload) if copy else payload
        idx += data_size
        self.flags = body[idx]
        idx += 1
        if self.flags & FLAG_HAS_NAME:
            ln = body[idx]
            idx += 1
            self.name = bytes(body[idx : idx + ln])
            idx += ln
        if self.flags & FLAG_HAS_MIME:
            ln = body[idx]
            idx += 1
            self.mime = bytes(body[idx : idx + ln])
            idx += ln
        if self.flags & FLAG_HAS_LAST_MODIFIED:
            self.last_modified = int.from_bytes(
                body[idx : idx + LAST_MODIFIED_BYTES], "big"
            )
            idx += LAST_MODIFIED_BYTES
        if self.flags & FLAG_HAS_TTL:
            self.ttl = t.TTL.from_bytes(bytes(body[idx : idx + 2]))
            idx += 2
        if self.flags & FLAG_HAS_PAIRS:
            (ps,) = struct.unpack_from(">H", body, idx)
            idx += 2
            self.pairs = bytes(body[idx : idx + ps])
            idx += ps

    @property
    def etag(self) -> str:
        return f"{self.checksum:08x}"


class CrcError(ValueError):
    """Stored checksum does not match the data (volume_read path rejects)."""
