"""Volume: one append-only `.dat` needle log + `.idx` index + in-memory map.

Port of the subset of seaweedfs_tpu/storage/volume.py that the EC encoder,
Store and the volume server call (reference: weed/storage/volume.go,
volume_write.go, volume_read.go, volume_loading.go).  Semantics preserved:
  - superblock at offset 0; needles appended 8-byte aligned
  - write: append record, then index entry (a crash between the two is
    recovered at load by trusting .dat over .idx)
  - read: offset/size from the map, pread, cookie check, CRC check
  - delete: append a tombstone needle (empty body) + tombstone idx entry
  - read(read_deleted=True) serves a deleted-but-not-vacuumed needle;
    read(zero_copy=True) keeps `data` a memoryview over the one pread
  - garbage ratio drives vacuum (volume_vacuum.go -> vacuum.py here)
  - the needle map is the in-memory CompactMap, or with `-index sqlite` /
    `-index native` a persistent map (needle_map_persistent.py) that
    replays only the .idx tail past its watermark at open
  - a tiered volume (volume_tier.go): its `.vif` names a `.dat` held by a
    storage backend (backend.py); it serves every read through one ranged
    read of RemoteDat and refuses writes, deletes and placement changes.
    A tiered volume that kept its local copy serves that, read-only.
  - the tail cursor (volume_backup.go, volume_grpc_tail.go):
    find_offset_since and scan_records, which VolumeTailSender streams

Vacuum swap: reads are lock-free, so the (dat file, needle map) pair is
published as one immutable _ReadState; vacuum's commit swaps the whole
state in a single reference assignment and leaves the old dat file open
for readers still holding the previous state (closed by refcounting when
they finish).
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import time
from dataclasses import dataclass

from . import backend as backend_mod
from . import idx as idx_mod
from . import needle as needle_mod
from . import needle_map
from . import types as t
from .needle import Needle
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .volume_info import load_volume_info


class NotFoundError(KeyError):
    pass


class CookieMismatch(PermissionError):
    pass


class VolumeReadOnly(RuntimeError):
    pass


@dataclass
class VolumeInfo:
    id: int
    collection: str
    size: int
    file_count: int
    delete_count: int
    deleted_bytes: int
    read_only: bool
    replica_placement: str
    ttl: str
    version: int
    compact_revision: int


class _ReadState:
    """Immutable (dat file, needle map) pair captured by lock-free reads."""

    __slots__ = ("dat", "nm")

    def __init__(self, dat, nm):
        self.dat = dat
        self.nm = nm


def _pread(dat, size: int, offset: int) -> bytes:
    """Ranged read from a local file or a tiered RemoteDat backend."""
    if hasattr(dat, "pread"):
        return dat.pread(size, offset)
    return os.pread(dat.fileno(), size, offset)


def _dat_size(dat) -> int:
    if hasattr(dat, "pread"):
        return dat.size()
    return os.fstat(dat.fileno()).st_size


class Volume:
    def __init__(
        self,
        dirname: str,
        vid: int,
        collection: str = "",
        replica_placement: t.ReplicaPlacement | None = None,
        ttl: t.TTL | None = None,
        version: int = needle_mod.CURRENT_VERSION,
        # "compact" (None) keeps the whole map in RAM (CompactMap);
        # "persistent" (SQLite) and "native" (the embedded KV) are the
        # reference's -index sqlite|native
        needle_map_kind: str | None = None,
    ):
        self.dir = dirname
        self.id = vid
        self.collection = collection
        self.needle_map_kind = needle_map_kind or "compact"
        self.read_only = False
        # size-induced write lock (reference noWriteCanDelete): the volume
        # stops accepting appends but still takes deletes
        self.full = False
        self._lock = threading.RLock()
        base = self.base_name(dirname, vid, collection)
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        self.note_path = base + ".note"
        self.vif_path = base + ".vif"
        self.remote_dat = None

        # tiered volume: the .dat lives on a storage backend, the .idx stays
        # local (volume_tier.go LoadRemoteFile)
        vinfo = load_volume_info(self.vif_path)
        self.remote_files = [f for f in vinfo.get("files", []) if f.get("key")]
        if self.remote_files and not os.path.exists(self.dat_path):
            rf = self.remote_files[0]
            storage = backend_mod.get_backend(
                rf["backendType"], rf.get("backendId", "default"))
            self.remote_dat = backend_mod.RemoteDat(
                storage, rf["key"], int(rf["fileSize"]))
            self.super_block = SuperBlock.from_bytes(
                self.remote_dat.pread(SUPER_BLOCK_SIZE, 0))
            self._state = _ReadState(self.remote_dat, self._build_map())
            self._idx = None
            self.read_only = True
            return

        if os.path.exists(self.dat_path):
            with open(self.dat_path, "rb") as f:
                self.super_block = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
            if os.path.exists(self.note_path):
                # .note marks a volume that was open for writing and not
                # cleanly closed; _recover_tail below heals the torn tail
                # (reference volume_write.go:85 marker)
                logging.getLogger("volume").warning(
                    "volume %d was not cleanly closed; recovering tail", vid
                )
            nm = self._build_map()
            self._recover_tail(nm)
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or t.ReplicaPlacement(),
                ttl=ttl or t.TTL(),
            )
            with open(self.dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
            open(self.idx_path, "ab").close()
            nm = self._build_map()
        self._state = _ReadState(open(self.dat_path, "r+b"), nm)
        self._idx = open(self.idx_path, "ab")
        if self.remote_files:
            # tiered with keep_local_dat_file: serve the local copy, but the
            # .vif still records the remote, so stay read-only and the two
            # copies cannot diverge
            self.read_only = True
        # dirty marker: present while the volume is open for writing, so a
        # crash is detectable on the next load; removed on clean close
        with open(self.note_path, "w") as f:
            f.write("open for writing\n")

    @property
    def sdx_path(self) -> str:
        return self.base_name(self.dir, self.id, self.collection) + ".sdx"

    @property
    def ndx_path(self) -> str:
        return self.base_name(self.dir, self.id, self.collection) + ".ndx"

    def _build_map(self, fresh: bool = False):
        """The volume's needle map in its configured kind.  `fresh=True`
        (vacuum's commit) starts a NEW db file: lock-free readers may still
        hold the old map over the old .dat, so the old db is unlinked (its
        open handle keeps the inode) rather than rebuilt in place."""
        if self.needle_map_kind == "persistent":
            from .needle_map_persistent import SqliteNeedleMap

            if fresh and os.path.exists(self.sdx_path):
                os.remove(self.sdx_path)
            return SqliteNeedleMap(self.sdx_path, self.idx_path, self.version)
        if self.needle_map_kind == "native":
            from .needle_map_persistent import NativeNeedleMap

            if fresh and os.path.exists(self.ndx_path):
                os.remove(self.ndx_path)
            return NativeNeedleMap(self.ndx_path, self.idx_path, self.version)
        return needle_map.CompactMap.load_from_idx(self.idx_path, self.version)

    @property
    def is_tiered(self) -> bool:
        """The .vif records a remote .dat (serving remotely, or a kept
        local copy that must not diverge from the uploaded one)."""
        return bool(self.remote_files)

    @property
    def nm(self) -> needle_map.CompactMap:
        return self._state.nm

    @property
    def _dat(self):
        return self._state.dat

    def _recover_tail(self, nm: needle_map.CompactMap) -> None:
        """Re-index complete CRC-valid records written after the last .idx
        entry (crash between .dat append and .idx append), then truncate any
        torn or corrupt tail to the last record boundary.  Only size>0
        records are recovered — a trailing size-0 record is ambiguous
        between an empty write and a delete tombstone."""
        indexed_end = max(SUPER_BLOCK_SIZE, nm.indexed_end)
        dat_size = os.path.getsize(self.dat_path)
        if dat_size <= indexed_end:
            return
        recovered = []
        with open(self.dat_path, "rb") as f:
            offset = indexed_end
            while offset + t.NEEDLE_HEADER_SIZE <= dat_size:
                f.seek(offset)
                _, nid, nsize = Needle.parse_header(f.read(t.NEEDLE_HEADER_SIZE))
                if not t.size_is_valid(nsize):
                    total = needle_mod.actual_size(0, self.version)
                    if offset + total > dat_size:
                        break  # torn tombstone record at EOF
                    offset += total
                    continue
                total = needle_mod.actual_size(nsize, self.version)
                if offset + total > dat_size:
                    break  # torn partial record at EOF
                f.seek(offset)
                try:
                    Needle.from_bytes(f.read(total), self.version)
                except (ValueError, IndexError, struct.error):
                    break  # garbage or corrupt tail
                recovered.append((nid, offset, nsize))
                offset += total
        if offset < dat_size:
            os.truncate(self.dat_path, offset)
        if recovered:
            with open(self.idx_path, "ab") as xf:
                for nid, off, size in recovered:
                    nm.set(nid, off, size)
                    xf.write(idx_mod.pack_entry(nid, off, size))

    # -- naming --------------------------------------------------------------

    @staticmethod
    def base_name(dirname: str, vid: int, collection: str = "") -> str:
        stem = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(dirname, stem)

    @property
    def version(self) -> int:
        return self.super_block.version

    # -- write path ----------------------------------------------------------

    def append_needle(self, n: Needle) -> tuple[int, int]:
        """Append; returns (actual_offset, size).  The volume's syncWrite
        (volume_write.go:93): record first, then index entry."""
        with self._lock:
            if self.is_tiered:
                raise VolumeReadOnly(f"volume {self.id} is tiered")
            if self.read_only or self.full:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            record = n.to_bytes(self.version)
            self._dat.seek(0, os.SEEK_END)
            offset = self._dat.tell()
            if offset % t.NEEDLE_PADDING_SIZE:  # heal torn tail like the ref
                offset += t.NEEDLE_PADDING_SIZE - offset % t.NEEDLE_PADDING_SIZE
                self._dat.seek(offset)
            if offset >= t.MAX_POSSIBLE_VOLUME_SIZE:
                raise ValueError(f"volume {self.id} exceeds max size")
            self._dat.write(record)
            self._dat.flush()
            self.nm.set(n.id, offset, n.size)
            self._idx.write(idx_mod.pack_entry(n.id, offset, n.size))
            self._idx.flush()
            return offset, n.size

    def write(
        self,
        needle_id: int,
        cookie: int,
        data: bytes,
        name: bytes = b"",
        mime: bytes = b"",
        ttl: t.TTL | None = None,
    ) -> int:
        """Convenience store; returns body size written."""
        n = Needle(
            id=needle_id,
            cookie=cookie,
            data=data,
            name=name,
            mime=mime,
            ttl=ttl or t.TTL(),
            last_modified=int(time.time()),
        )
        self.append_needle(n)
        return n.size

    def delete(self, needle_id: int, cookie: int | None = None) -> int:
        """Tombstone; returns reclaimed byte count (0 if absent)."""
        with self._lock:
            if self.is_tiered:
                raise VolumeReadOnly(f"volume {self.id} is tiered")
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            loc = self.nm.get(needle_id)
            if loc is None:
                return 0
            if cookie is not None:
                stored = self._read_at(loc[0], loc[1])
                if stored.cookie != cookie:
                    raise CookieMismatch(f"cookie mismatch for {needle_id:x}")
            tomb = Needle(id=needle_id, cookie=cookie or 0)
            record = tomb.to_bytes(self.version)
            self._dat.seek(0, os.SEEK_END)
            self._dat.write(record)
            self._dat.flush()
            reclaimed = self.nm.delete(needle_id)
            self._idx.write(
                idx_mod.pack_entry(needle_id, 0, t.TOMBSTONE_FILE_SIZE)
            )
            self._idx.flush()
            return reclaimed

    # -- read path -----------------------------------------------------------

    def _read_at(
        self,
        offset: int,
        size: int,
        st: _ReadState | None = None,
        zero_copy: bool = False,
    ) -> Needle:
        st = st or self._state
        total = needle_mod.actual_size(size, self.version)
        buf = _pread(st.dat, total, offset)
        # zero_copy: data stays a memoryview over this one ranged read
        return Needle.from_bytes(buf, self.version, copy=not zero_copy)

    def read(
        self,
        needle_id: int,
        cookie: int | None = None,
        read_deleted: bool = False,
        zero_copy: bool = False,
    ) -> Needle:
        # one state capture: the offset from st.nm is only ever applied to
        # st.dat, so a concurrent vacuum swap can't mix old map / new file
        st = self._state
        loc = st.nm.get(needle_id)
        if loc is not None:
            n = self._read_at(loc[0], loc[1], st, zero_copy=zero_copy)
        else:
            n = self._read_tombstoned(needle_id, st) if read_deleted else None
            if n is None:
                raise NotFoundError(
                    f"needle {needle_id:x} not found in volume {self.id}"
                )
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(f"cookie mismatch for needle {needle_id:x}")
        return n

    def _tombstoned_location(
        self, needle_id: int, st: _ReadState
    ) -> tuple[int, int] | None:
        """(offset, original size) of a deleted-but-not-vacuumed needle:
        the map keeps the original record's offset under the tombstone,
        and the record's own header carries the pre-delete size."""
        raw = st.nm.get_any(needle_id)
        if raw is None:
            return None
        hdr = _pread(st.dat, t.NEEDLE_HEADER_SIZE, raw[0])
        if len(hdr) < t.NEEDLE_HEADER_SIZE:
            return None
        _, _, size = Needle.parse_header(hdr)
        if not t.size_is_valid(size):
            return None
        return raw[0], size

    def deleted_needle_size(self, needle_id: int) -> int | None:
        """Size a ?readDeleted=true read would return (throttle hints)."""
        loc = self._tombstoned_location(needle_id, self._state)
        return loc[1] if loc else None

    def _read_tombstoned(self, needle_id: int, st: _ReadState) -> Needle | None:
        """Deleted-but-not-vacuumed needle (?readDeleted=true, reference
        ReadOption.ReadDeleted)."""
        loc = self._tombstoned_location(needle_id, st)
        if loc is None:
            return None
        return self._read_at(loc[0], loc[1], st)

    def has(self, needle_id: int) -> bool:
        return self.nm.has(needle_id)

    # -- stats / lifecycle ---------------------------------------------------

    @property
    def content_size(self) -> int:
        if self.remote_dat is not None:
            return self.remote_dat.size()
        self._dat.flush()
        return os.path.getsize(self.dat_path)

    @property
    def garbage_ratio(self) -> float:
        s = self.nm.stats
        total = s.file_bytes + s.deleted_bytes
        return (s.deleted_bytes / total) if total else 0.0

    def info(self) -> VolumeInfo:
        s = self.nm.stats
        return VolumeInfo(
            id=self.id,
            collection=self.collection,
            size=self.content_size,
            file_count=len(self.nm),
            delete_count=s.deleted_count,
            deleted_bytes=s.deleted_bytes,
            read_only=self.read_only or self.full,
            replica_placement=str(self.super_block.replica_placement),
            ttl=str(self.super_block.ttl),
            version=self.version,
            compact_revision=self.super_block.compaction_revision,
        )

    def _walk_records(self, start_offset: int, st: _ReadState | None = None):
        """Yield (offset, header_bytes, rest_bytes, header_size, Needle) for
        every record from start_offset to EOF.  One _ReadState is captured
        for the whole walk so a concurrent vacuum swap can't mix old
        offsets with the compacted file (same discipline as read())."""
        st = st or self._state
        size = _dat_size(st.dat)
        offset = max(start_offset, SUPER_BLOCK_SIZE)
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            hdr = _pread(st.dat, t.NEEDLE_HEADER_SIZE, offset)
            if len(hdr) < t.NEEDLE_HEADER_SIZE:
                break
            _, _, nsize = Needle.parse_header(hdr)
            body_size = max(nsize, 0)
            total = needle_mod.actual_size(body_size, self.version)
            if offset + total > size:
                break  # torn record at EOF — stop, don't crash
            rest = _pread(st.dat, total - t.NEEDLE_HEADER_SIZE,
                          offset + len(hdr))
            n = Needle.from_bytes(hdr + rest, self.version, verify=False)
            yield offset, hdr, rest, nsize, n
            offset += total

    def scan(self, include_deleted: bool = False):
        """Yield (offset, Needle) for every record in .dat file order —
        the scan_volume_file analogue vacuum walks."""
        self._dat.flush()
        for offset, _, _, nsize, n in self._walk_records(SUPER_BLOCK_SIZE):
            if include_deleted or t.size_is_valid(nsize):
                yield offset, n

    def update_replica_placement(self, rp: t.ReplicaPlacement) -> None:
        """Persist a new replica placement into the on-disk superblock
        (volume_super_block.go maybeWriteSuperBlock on configure)."""
        with self._lock:
            if self.is_tiered:
                raise VolumeReadOnly(f"volume {self.id} is tiered")
            self.super_block.replica_placement = rp
            os.pwrite(self._dat.fileno(), self.super_block.to_bytes(), 0)
            self._dat.flush()

    def sync(self) -> None:
        with self._lock:
            if self.remote_dat is not None:
                return
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self._idx.flush()
            os.fsync(self._idx.fileno())
            # a persistent map commits too: a second map opened over the
            # same db (the reload after a tier move) must not find it
            # locked (the reference's sqlite map fails there)
            if hasattr(self.nm, "flush"):
                self.nm.flush()

    def close(self) -> None:
        with self._lock:
            if self.remote_dat is not None:
                if not self.remote_dat.closed and hasattr(self.nm, "close"):
                    self.nm.close()
                self.remote_dat.close()
                return
            clean = not self._dat.closed or not self._idx.closed
            if not self._dat.closed:
                self._dat.flush()
                self._dat.close()
            if not self._idx.closed:
                self._idx.flush()
                self._idx.close()
            if clean and hasattr(self.nm, "close"):
                self.nm.close()
            if clean and os.path.exists(self.note_path):
                os.remove(self.note_path)

    def destroy(self) -> None:
        self.close()
        if self.remote_dat is not None:
            self.remote_dat.storage.delete_key(self.remote_dat.key)
        for p in (self.dat_path, self.idx_path, self.note_path, self.vif_path,
                  self.sdx_path, self.ndx_path):
            if os.path.exists(p):
                os.remove(p)

    # -- tail sync (incremental replica catch-up) ---------------------------

    def _append_at_ns_at(self, dat, offset: int, size: int) -> int:
        """The v3 append timestamp of the record at `offset` (the 8 bytes
        just before the padding, needle.py to_bytes)."""
        total = needle_mod.actual_size(size, self.version)
        pad = needle_mod.padding_length(size, self.version)
        return int.from_bytes(_pread(dat, 8, offset + total - pad - 8), "big")

    def find_offset_since(self, since_ns: int) -> int:
        """A .dat offset from which scanning forward covers every record
        with append_at_ns > since_ns (BinarySearchByAppendAtNs,
        volume_backup.go).  The binary search runs over the live map
        entries (offsets increase in append order); the result backs up to
        the preceding live record so delete tombstones between live
        needles are never skipped — callers filter by timestamp.  One
        _ReadState capture keeps the search consistent under a concurrent
        vacuum swap."""
        if since_ns == 0 or self.version != needle_mod.VERSION3:
            # from the beginning; v1/v2 records carry no timestamps, so a
            # nonzero cursor can't be honored — resend everything
            return SUPER_BLOCK_SIZE
        st = self._state
        entries = sorted(
            (off, size)
            for _, off, size in st.nm.items()
            if off > 0 and t.size_is_valid(size)
        )
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._append_at_ns_at(st.dat, *entries[mid]) > since_ns:
                hi = mid
            else:
                lo = mid + 1
        # back up one live record: tombstones appended between live needle
        # lo-1 and live needle lo may still be newer than the cursor
        if lo == 0:
            return SUPER_BLOCK_SIZE
        return entries[lo - 1][0]

    def scan_records(self, start_offset: int):
        """Yield (offset, header_bytes, rest_bytes, Needle) for every record
        from start_offset to EOF — the wire-shaped scan the tail streams
        (ScanVolumeFileFrom, volume_grpc_tail.go)."""
        self._dat.flush()
        for offset, hdr, rest, _, n in self._walk_records(start_offset):
            yield offset, hdr, rest, n
