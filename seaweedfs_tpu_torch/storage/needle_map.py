"""Needle maps: in-memory needle_id -> (offset, size) with .idx persistence.

The reference offers a compact in-memory map, leveldb, and sorted-file
variants (weed/storage/needle_map.go, needle_map/compact_map.go,
needle_map/memdb.go).  In Python the idiomatic equivalents:

  - CompactMap: dict-backed live map with running counters (the default;
    a dict of int->packed-int is ~80B/entry — fine for tens of millions).
  - MemDb: sorted-array map used for building `.ecx` files and batch jobs;
    numpy structured arrays + binary search, matching memdb's btree role.

Both track the same stats the reference reports in heartbeats
(file/deletion counts and byte totals, needle_map_metric.go).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import idx as idx_mod
from . import needle as needle_mod
from . import types as t


@dataclass
class MapStats:
    file_count: int = 0
    deleted_count: int = 0
    file_bytes: int = 0
    deleted_bytes: int = 0
    maximum_key: int = 0


class CompactMap:
    """Live volume index: id -> (actual_offset, size). Deletions keep the
    entry with TOMBSTONE size so reads answer "deleted" not "unknown"."""

    def __init__(self):
        self._m: dict[int, tuple[int, int]] = {}
        self.stats = MapStats()
        self._live = 0
        # Highest end-offset any .idx entry ever claimed in .dat (including
        # entries later superseded or tombstoned) — the tail-recovery
        # watermark, computed during load instead of a second .idx pass.
        self.indexed_end = 0

    def set(self, needle_id: int, actual_offset: int, size: int) -> None:
        old = self._m.get(needle_id)
        old_live = old is not None and t.size_is_valid(old[1])
        if old_live:
            self.stats.deleted_count += 1
            self.stats.deleted_bytes += old[1]
        # size-0 entries (empty writes) are dead on arrival: get() won't
        # return them, so they must not count as live either
        self._live += int(t.size_is_valid(size)) - int(old_live)
        self._m[needle_id] = (actual_offset, size)
        self.stats.file_count += 1
        self.stats.file_bytes += max(size, 0)
        self.stats.maximum_key = max(self.stats.maximum_key, needle_id)

    def delete(self, needle_id: int) -> int:
        """Returns the size of the deleted needle (0 if absent/already gone)."""
        old = self._m.get(needle_id)
        if old is None or not t.size_is_valid(old[1]):
            return 0
        self._m[needle_id] = (old[0], t.TOMBSTONE_FILE_SIZE)
        self.stats.deleted_count += 1
        self.stats.deleted_bytes += old[1]
        self._live -= 1
        return old[1]

    def get(self, needle_id: int) -> tuple[int, int] | None:
        """(actual_offset, size) of a live needle, else None."""
        v = self._m.get(needle_id)
        if v is None or not t.size_is_valid(v[1]):
            return None
        return v

    def get_any(self, needle_id: int) -> tuple[int, int] | None:
        """Raw entry INCLUDING tombstoned ones: a delete only marks the
        size, so the original record's offset survives until vacuum —
        what ?readDeleted=true reads (reference ReadOption.ReadDeleted)."""
        return self._m.get(needle_id)

    def has(self, needle_id: int) -> bool:
        return self.get(needle_id) is not None

    def __len__(self) -> int:
        return self._live

    def items(self):
        for k, (off, size) in self._m.items():
            if t.size_is_valid(size):
                yield k, off, size

    # -- .idx persistence ----------------------------------------------------

    @classmethod
    def load_from_idx(cls, path: str, version: int | None = None) -> "CompactMap":
        """Replay a .idx into a live map (volume_loading.go behavior:
        tombstones and re-writes applied in order).  When `version` is given,
        `indexed_end` tracks the highest record end any entry claims so
        Volume tail recovery needs no second .idx read."""
        m = cls()
        if not os.path.exists(path):
            return m
        with open(path, "rb") as f:
            ids, offs, sizes = idx_mod.parse_buffer(f.read())
        for i in range(len(ids)):
            nid, off, size = int(ids[i]), int(offs[i]), int(sizes[i])
            if t.size_is_valid(size):
                m.set(nid, off, size)
                if version is not None:
                    end = off + needle_mod.actual_size(size, version)
                    if end > m.indexed_end:
                        m.indexed_end = end
            else:
                m.delete(nid)
        return m


class MemDb:
    """Batch/sorted map: build from entries or a .idx, query by binary
    search, emit entries ascending by needle id (the .ecx builder,
    reference WriteSortedFileFromIdx ec_encoder.go:27-54)."""

    def __init__(self, ids=None, offsets=None, sizes=None):
        self.ids = np.asarray(ids if ids is not None else [], dtype=np.uint64)
        self.offsets = np.asarray(
            offsets if offsets is not None else [], dtype=np.int64
        )
        self.sizes = np.asarray(sizes if sizes is not None else [], dtype=np.int32)

    @classmethod
    def load_from_idx(cls, path: str) -> "MemDb":
        """Replay .idx (applying tombstones), keep live needles sorted by id."""
        live = CompactMap.load_from_idx(path)
        entries = sorted(live.items())
        if not entries:
            return cls()
        ids, offs, sizes = zip(*entries)
        return cls(ids, offs, sizes)

    def get(self, needle_id: int) -> tuple[int, int] | None:
        i = np.searchsorted(self.ids, np.uint64(needle_id))
        if i < len(self.ids) and self.ids[i] == needle_id:
            return int(self.offsets[i]), int(self.sizes[i])
        return None

    def __len__(self) -> int:
        return len(self.ids)

    def to_sorted_bytes(self) -> bytes:
        """Entries ascending by id, 16B each — the .ecx payload."""
        out = bytearray()
        for i in range(len(self.ids)):
            out += idx_mod.pack_entry(
                int(self.ids[i]), int(self.offsets[i]), int(self.sizes[i])
            )
        return bytes(out)


def write_sorted_file_from_idx(idx_path: str, ecx_path: str) -> None:
    """Build the sorted-by-id index sidecar (.ecx) from a .idx."""
    db = MemDb.load_from_idx(idx_path)
    with open(ecx_path, "wb") as f:
        f.write(db.to_sorted_bytes())

