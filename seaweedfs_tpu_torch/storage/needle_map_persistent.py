"""Persistent needle maps: O(1)-memory volume indexes.

Port of seaweedfs_tpu/storage/needle_map_persistent.py (reference:
weed/storage/needle_map_leveldb.go) — a persistent map so huge volumes
don't replay their whole .idx into RAM at startup; a watermark records how
many .idx bytes are already folded into the db, and open() replays only
the tail.  Two backends play the LevelDB role:

  SqliteNeedleMap  (`-index sqlite`) — SQLite's B-tree
  NativeNeedleMap  (`-index native`) — the embedded C++ KV
                   (csrc/host/kvstore.cpp, storage/kvstore.py)

Both are interface-compatible with CompactMap (set/delete/get/get_any/
has/items/len/stats/indexed_end) so Volume can swap kinds; the
crash-safety watermark/replay discipline lives ONCE in the shared base
class.

Crash-safety: set/delete are idempotent on replay (a re-applied entry
with identical values doesn't re-count stats), so a stale watermark
after a crash just replays a little extra tail.  A watermark LARGER than
the .idx (vacuum rewrote the index) triggers a full rebuild.
"""
from __future__ import annotations

import os
import sqlite3
import struct
import threading

from . import idx as idx_mod
from . import needle as needle_mod
from . import types as t
from .needle_map import MapStats

_FLUSH_EVERY = 256  # ops between commits+watermark updates

_META_KEYS = (
    "file_count", "deleted_count", "file_bytes", "deleted_bytes",
    "maximum_key", "live", "indexed_end", "watermark",
)


class _PersistentNeedleMap:
    """Shared watermark/replay/stats logic; subclasses provide the row
    storage primitives (_get_raw/_put_raw/_reset_rows/_iter_raw) and meta
    persistence (_load_meta/_store_meta)."""

    def __init__(self, db_path: str, idx_path: str, version: int | None = None):
        self.db_path = db_path
        self.idx_path = idx_path
        self.version = version
        self._lock = threading.Lock()
        self._open_store()
        meta = self._load_meta()
        if meta is not None:
            (fc, dc, fb, db, mk, live, indexed_end, watermark) = meta
            self.stats = MapStats(fc, dc, fb, db, mk)
            self._live = live
            self.indexed_end = indexed_end
            self._meta_watermark = watermark
        else:
            self.stats = MapStats()
            self._live = 0
            self.indexed_end = 0
            self._meta_watermark = 0
        self._ops = 0
        self._replaying = False
        self._replay_idx_tail()

    # -- storage primitives (subclass responsibility) -----------------------

    def _open_store(self) -> None:
        raise NotImplementedError

    def _load_meta(self) -> tuple | None:
        """-> the 8 _META_KEYS values, or None on first open."""
        raise NotImplementedError

    def _store_meta(self, values: tuple) -> None:
        raise NotImplementedError

    def _get_raw(self, needle_id: int) -> tuple[int, int] | None:
        raise NotImplementedError

    def _put_raw(self, needle_id: int, offset: int, size: int) -> None:
        raise NotImplementedError

    def _iter_raw(self):
        """Yield every (nid, off, size) row, tombstones included."""
        raise NotImplementedError

    def _reset_rows(self) -> None:
        raise NotImplementedError

    def _sync(self) -> None:
        """Make prior writes durable (commit / flush)."""
        raise NotImplementedError

    def _close_store(self) -> None:
        raise NotImplementedError

    # -- shared logic --------------------------------------------------------

    def _save_meta(self) -> None:
        s = self.stats
        self._store_meta(
            (
                s.file_count, s.deleted_count, s.file_bytes,
                s.deleted_bytes, s.maximum_key, self._live,
                self.indexed_end, self._meta_watermark,
            )
        )
        self._sync()

    def _replay_idx_tail(self) -> None:
        """Fold .idx entries past the watermark into the store
        (needle_map_leveldb.go generateLevelDbFile's incremental path)."""
        idx_size = (
            os.path.getsize(self.idx_path)
            if os.path.exists(self.idx_path)
            else 0
        )
        watermark = self._meta_watermark
        if watermark > idx_size:
            # .idx was rewritten (vacuum) — rebuild from scratch
            self._reset_rows()
            self.stats = MapStats()
            self._live = 0
            self.indexed_end = 0
            watermark = 0
        if watermark >= idx_size:
            self._meta_watermark = watermark
            return
        with open(self.idx_path, "rb") as f:
            f.seek(watermark)
            ids, offs, sizes = idx_mod.parse_buffer(f.read())
        # during replay the watermark must track what's actually been
        # folded — a periodic _bump commit with the full file size would
        # make a mid-replay crash skip the unapplied tail forever
        self._replaying = True
        try:
            for i in range(len(ids)):
                self._meta_watermark = watermark + (i + 1) * idx_mod.entry_size()
                nid, off, size = int(ids[i]), int(offs[i]), int(sizes[i])
                if t.size_is_valid(size):
                    self.set(nid, off, size)
                else:
                    self.delete(nid)
        finally:
            self._replaying = False
        self._meta_watermark = idx_size
        with self._lock:
            self._save_meta()

    # -- CompactMap-compatible surface --------------------------------------

    def set(self, needle_id: int, actual_offset: int, size: int) -> None:
        with self._lock:
            old = self._get_raw(needle_id)
            if old == (actual_offset, size):
                return  # idempotent replay
            old_live = old is not None and t.size_is_valid(old[1])
            if old_live:
                self.stats.deleted_count += 1
                self.stats.deleted_bytes += old[1]
            self._live += int(t.size_is_valid(size)) - int(old_live)
            self._put_raw(needle_id, actual_offset, size)
            self.stats.file_count += 1
            self.stats.file_bytes += max(size, 0)
            self.stats.maximum_key = max(self.stats.maximum_key, needle_id)
            # keep the persisted recovery watermark current on LIVE writes
            # too — otherwise reopen rescans the whole .dat and can
            # resurrect tombstoned needles from their stale live records
            if self.version is not None and t.size_is_valid(size):
                end = actual_offset + needle_mod.actual_size(size, self.version)
                if end > self.indexed_end:
                    self.indexed_end = end
            self._bump()

    def delete(self, needle_id: int) -> int:
        with self._lock:
            old = self._get_raw(needle_id)
            if old is None or not t.size_is_valid(old[1]):
                return 0
            self._put_raw(needle_id, old[0], t.TOMBSTONE_FILE_SIZE)
            self.stats.deleted_count += 1
            self.stats.deleted_bytes += old[1]
            self._live -= 1
            self._bump()
            return old[1]

    def _bump(self) -> None:
        self._ops += 1
        if self._ops >= _FLUSH_EVERY:
            self._ops = 0
            if not self._replaying:
                self._meta_watermark = (
                    os.path.getsize(self.idx_path)
                    if os.path.exists(self.idx_path)
                    else 0
                )
            self._save_meta()

    def get(self, needle_id: int) -> tuple[int, int] | None:
        with self._lock:
            row = self._get_raw(needle_id)
        if row is None or not t.size_is_valid(row[1]):
            return None
        return row

    def get_any(self, needle_id: int) -> tuple[int, int] | None:
        """Raw row INCLUDING tombstones (delete keeps the original offset)
        — the ?readDeleted=true surface, same contract as
        CompactMap.get_any."""
        with self._lock:
            return self._get_raw(needle_id)

    def has(self, needle_id: int) -> bool:
        return self.get(needle_id) is not None

    def __len__(self) -> int:
        return self._live

    def items(self):
        with self._lock:
            rows = list(self._iter_raw())
        for nid, off, size in rows:
            if t.size_is_valid(size):
                yield nid, off, size

    def flush(self) -> None:
        with self._lock:
            self._meta_watermark = (
                os.path.getsize(self.idx_path)
                if os.path.exists(self.idx_path)
                else 0
            )
            self._save_meta()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._close_store()


class SqliteNeedleMap(_PersistentNeedleMap):
    """`-index sqlite`: rows in a SQLite B-tree."""

    def _open_store(self) -> None:
        self.conn = sqlite3.connect(self.db_path, check_same_thread=False)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS needles"
            " (nid INTEGER PRIMARY KEY, off INTEGER, size INTEGER)"
        )
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)"
        )

    def _meta(self, key: str) -> int:
        row = self.conn.execute(
            "SELECT v FROM meta WHERE k = ?", (key,)
        ).fetchone()
        return int(row[0]) if row else 0

    def _load_meta(self) -> tuple | None:
        # absent rows read as 0, matching the historical first-open state
        return tuple(self._meta(k) for k in _META_KEYS)

    def _store_meta(self, values: tuple) -> None:
        self.conn.executemany(
            "INSERT OR REPLACE INTO meta (k, v) VALUES (?, ?)",
            list(zip(_META_KEYS, values)),
        )

    def _get_raw(self, needle_id: int) -> tuple[int, int] | None:
        row = self.conn.execute(
            "SELECT off, size FROM needles WHERE nid = ?", (needle_id,)
        ).fetchone()
        return (row[0], row[1]) if row is not None else None

    def _put_raw(self, needle_id: int, offset: int, size: int) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO needles (nid, off, size) VALUES (?, ?, ?)",
            (needle_id, offset, size),
        )

    def _iter_raw(self):
        yield from self.conn.execute("SELECT nid, off, size FROM needles")

    def _reset_rows(self) -> None:
        self.conn.execute("DELETE FROM needles")
        self.conn.execute("DELETE FROM meta")

    def _sync(self) -> None:
        self.conn.commit()

    def _close_store(self) -> None:
        self.conn.close()


class NativeNeedleMap(_PersistentNeedleMap):
    """`-index native`: rows in the embedded C++ KV (csrc/host/kvstore.cpp)
    — the closest analogue of the reference linking leveldb.  Records:
    8-byte big-endian needle id -> packed (offset i64, size i32); one
    meta record carries stats + the .idx replay watermark."""

    def _open_store(self) -> None:
        from .kvstore import NativeKv

        self.kv = NativeKv(self.db_path)

    def _load_meta(self) -> tuple | None:
        blob = self.kv.get(b"\xffmeta")
        return struct.unpack("<8q", blob) if blob is not None else None

    def _store_meta(self, values: tuple) -> None:
        self.kv.put(b"\xffmeta", struct.pack("<8q", *values))

    @staticmethod
    def _key(needle_id: int) -> bytes:
        return needle_id.to_bytes(8, "big")

    def _get_raw(self, needle_id: int) -> tuple[int, int] | None:
        blob = self.kv.get(self._key(needle_id))
        if blob is None:
            return None
        return struct.unpack("<qi", blob)

    def _put_raw(self, needle_id: int, offset: int, size: int) -> None:
        self.kv.put(self._key(needle_id), struct.pack("<qi", offset, size))

    def _iter_raw(self):
        for k, v in self.kv.items():
            if len(k) != 8:
                continue  # meta record
            off, size = struct.unpack("<qi", v)
            yield int.from_bytes(k, "big"), off, size

    def _reset_rows(self) -> None:
        # restart the kv file from scratch (vacuum rewrote the .idx)
        from .kvstore import NativeKv

        self.kv.close()
        os.remove(self.db_path)
        self.kv = NativeKv(self.db_path)

    def _sync(self) -> None:
        self.kv.flush()

    def _close_store(self) -> None:
        self.kv.close()
