"""`.idx` file: the needle index sidecar.

16-byte entries, appended on every write/delete (reference:
weed/storage/idx/walk.go, weed/storage/needle_map/compact_map.go callers):

    needle_id u64be | offset u32be (8-byte units) | size i32be

size == -1 (tombstone) marks deletion; offset 0 + size 0 from deletions of
absent needles.  numpy-vectorized parse: a whole .idx loads as three arrays
in one pass instead of a per-entry loop.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from . import types as t


def entry_size() -> int:
    """Current on-disk entry width: 16, or 17 in 5-byte-offset mode
    (t.set_offset_size)."""
    return t.NEEDLE_MAP_ENTRY_SIZE


def pack_entry(needle_id: int, actual_offset: int, size: int) -> bytes:
    return (
        needle_id.to_bytes(8, "big")
        + t.offset_to_bytes(actual_offset)
        + int(size).to_bytes(4, "big", signed=True)
    )


def parse_buffer(buf: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bulk-parse entries -> (ids u64, actual_offsets i64, sizes i32)."""
    entry = entry_size()
    n = len(buf) // entry
    a = np.frombuffer(buf[: n * entry], dtype=np.uint8).reshape(n, entry)
    ids = a[:, :8].copy().view(">u8").reshape(n).astype(np.uint64)
    offs = a[:, 8:12].copy().view(">u4").reshape(n).astype(np.int64)
    if t.OFFSET_SIZE == 5:  # high byte appended after the low word
        offs += a[:, 12].astype(np.int64) << 32
    offs *= t.NEEDLE_PADDING_SIZE
    lo = 8 + t.OFFSET_SIZE
    sizes = a[:, lo : lo + 4].copy().view(">i4").reshape(n).astype(np.int32)
    return ids, offs, sizes


def walk(path: str) -> Iterator[tuple[int, int, int]]:
    """Yield (needle_id, actual_offset, size) per entry, in file order."""
    with open(path, "rb") as f:
        buf = f.read()
    ids, offs, sizes = parse_buffer(buf)
    for i in range(len(ids)):
        yield int(ids[i]), int(offs[i]), int(sizes[i])


def entry_count(path: str) -> int:
    return os.path.getsize(path) // entry_size()
