"""Core storage types and on-disk scalar encodings.

Byte-compatible with the reference formats (all big-endian):
  - NeedleId: u64 (weed/storage/types/needle_id_type.go)
  - Cookie:   u32 (needle_types.go:31)
  - Size:     i32, -1 = tombstone (needle_types.go:15-22)
  - Offset:   u32 count of 8-byte units (offset_4bytes.go, 32GB max volume)
  - TTL:      count byte + unit byte (needle/volume_ttl.go)
  - ReplicaPlacement: dc*100 + rack*10 + node digits (super_block/replica_placement.go)
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
COOKIE_SIZE = 4
SIZE_SIZE = 4
OFFSET_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 (17 in 5-byte mode)
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
TOMBSTONE_FILE_SIZE = -1
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB (4B offsets × 8B units)

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I32 = struct.Struct(">i")


def set_offset_size(n: int) -> None:
    """Runtime analogue of the reference's `5BytesOffset` build tag
    (types/offset_5bytes.go:14-17): 5-byte needle-map offsets raise the
    volume address cap from 32GB to 8TB.  Like the build tag this is a
    PROCESS-WIDE deployment choice made once at startup — .idx/.ecx
    files written in one mode are not readable in the other, so every
    node in a cluster must agree (the master flips it when
    -volumeSizeLimitMB exceeds the 4-byte cap; volume servers via
    -offset.bytes).  On-disk 5-byte layout matches the reference:
    4-byte big-endian low word, then the high byte (offset_5bytes.go
    OffsetToBytes)."""
    global OFFSET_SIZE, NEEDLE_MAP_ENTRY_SIZE, MAX_POSSIBLE_VOLUME_SIZE
    if n not in (4, 5):
        raise ValueError(f"offset size must be 4 or 5, got {n}")
    OFFSET_SIZE = n
    NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + n + SIZE_SIZE
    MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * n)) * NEEDLE_PADDING_SIZE


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def offset_to_bytes(actual_offset: int) -> bytes:
    """Byte offset (multiple of 8) -> OFFSET_SIZE-byte on-disk unit count."""
    assert actual_offset % NEEDLE_PADDING_SIZE == 0, actual_offset
    units = actual_offset // NEEDLE_PADDING_SIZE
    if OFFSET_SIZE == 4:
        return _U32.pack(units)
    return _U32.pack(units & 0xFFFFFFFF) + bytes([units >> 32])


def offset_from_bytes(b: bytes) -> int:
    """OFFSET_SIZE-byte unit count -> actual byte offset."""
    units = _U32.unpack(b[:4])[0]
    if OFFSET_SIZE == 5:
        units += b[4] << 32
    return units * NEEDLE_PADDING_SIZE


# --- TTL --------------------------------------------------------------------

_TTL_UNITS = {0: "", 1: "m", 2: "h", 3: "d", 4: "w", 5: "M", 6: "y"}
_TTL_FROM_CHAR = {v: k for k, v in _TTL_UNITS.items() if v}
_TTL_MINUTES = {1: 1, 2: 60, 3: 24 * 60, 4: 7 * 24 * 60, 5: 31 * 24 * 60, 6: 365 * 24 * 60}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def parse(cls, s: str) -> "TTL":
        if not s:
            return cls(0, 0)
        m = re.fullmatch(r"(\d+)([mhdwMy])", s)
        if not m:
            raise ValueError(f"bad TTL {s!r}")
        return cls(int(m.group(1)), _TTL_FROM_CHAR[m.group(2)])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        return cls(b[0], b[1]) if len(b) >= 2 and b[1] in _TTL_UNITS else cls(0, 0)

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit])

    @property
    def minutes(self) -> int:
        return self.count * _TTL_MINUTES.get(self.unit, 0)

    def __str__(self) -> str:
        if not self.count or not self.unit:
            return ""
        return f"{self.count}{_TTL_UNITS[self.unit]}"

    def __bool__(self) -> bool:
        return bool(self.count and self.unit)


# --- replica placement ------------------------------------------------------


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        if len(s) != 3 or not s.isdigit() or any(int(c) > 2 for c in s):
            raise ValueError(f"bad replica placement {s!r}")
        return cls(diff_dc=int(s[0]), diff_rack=int(s[1]), same_rack=int(s[2]))

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


# --- file ids ---------------------------------------------------------------


def format_fid(volume_id: int, needle_id: int, cookie: int) -> str:
    """'vid,keyhexcookiehex' — the public object handle (e.g. '3,01637037d6').
    Needle id hex is left-trimmed of zero pairs like the reference's
    formatNeedleIdCookie."""
    nid_hex = f"{needle_id:016x}".lstrip("0") or "0"
    if len(nid_hex) % 2:
        nid_hex = "0" + nid_hex
    return f"{volume_id},{nid_hex}{cookie:08x}"


def parse_fid(fid: str) -> tuple[int, int, int]:
    """'vid,keycookie[_N]' -> (volume_id, needle_id, cookie).

    The '_N' suffix of a count>1 assignment is a decimal delta ADDED to the
    needle id (reference weed/storage/needle/needle.go ParsePath: n.Id +=
    delta), so each file of the batch lands on its own needle."""
    try:
        vid_s, rest = fid.split(",", 1)
        delta = 0
        if "_" in rest:
            rest, delta_s = rest.split("_", 1)
            if not (delta_s.isascii() and delta_s.isdigit()):
                # strconv.ParseUint semantics: ASCII digits only
                raise ValueError
            delta = int(delta_s)
        volume_id = int(vid_s)
        if len(rest) <= 8:
            raise ValueError
        needle_id = int(rest[:-8], 16) + delta
        cookie = int(rest[-8:], 16)
        return volume_id, needle_id, cookie
    except ValueError as e:
        raise ValueError(f"invalid fid {fid!r}") from e
