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

Tiered (remote) volumes, the persistent needle maps, vacuum and tail sync
are ROADMAP A4b.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import time
from dataclasses import dataclass

from . import idx as idx_mod
from . import needle as needle_mod
from . import needle_map
from . import types as t
from .needle import Needle
from .super_block import SUPER_BLOCK_SIZE, SuperBlock


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


class Volume:
    def __init__(
        self,
        dirname: str,
        vid: int,
        collection: str = "",
        replica_placement: t.ReplicaPlacement | None = None,
        ttl: t.TTL | None = None,
        version: int = needle_mod.CURRENT_VERSION,
    ):
        self.dir = dirname
        self.id = vid
        self.collection = collection
        self.read_only = False
        # size-induced write lock (reference noWriteCanDelete): the volume
        # stops accepting appends but still takes deletes
        self.full = False
        self._lock = threading.RLock()
        base = self.base_name(dirname, vid, collection)
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        self.note_path = base + ".note"

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
            self.nm = needle_map.CompactMap.load_from_idx(self.idx_path, self.version)
            self._recover_tail()
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or t.ReplicaPlacement(),
                ttl=ttl or t.TTL(),
            )
            with open(self.dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
            open(self.idx_path, "ab").close()
            self.nm = needle_map.CompactMap.load_from_idx(self.idx_path, self.version)
        self._dat = open(self.dat_path, "r+b")
        self._idx = open(self.idx_path, "ab")
        # dirty marker: present while the volume is open for writing, so a
        # crash is detectable on the next load; removed on clean close
        with open(self.note_path, "w") as f:
            f.write("open for writing\n")

    def _recover_tail(self) -> None:
        """Re-index complete CRC-valid records written after the last .idx
        entry (crash between .dat append and .idx append), then truncate any
        torn or corrupt tail to the last record boundary.  Only size>0
        records are recovered — a trailing size-0 record is ambiguous
        between an empty write and a delete tombstone."""
        nm = self.nm
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

    def _read_at(self, offset: int, size: int, zero_copy: bool = False) -> Needle:
        total = needle_mod.actual_size(size, self.version)
        buf = os.pread(self._dat.fileno(), total, offset)
        # zero_copy: data stays a memoryview over this pread's own buffer
        return Needle.from_bytes(buf, self.version, copy=not zero_copy)

    def read(
        self,
        needle_id: int,
        cookie: int | None = None,
        read_deleted: bool = False,
        zero_copy: bool = False,
    ) -> Needle:
        loc = self.nm.get(needle_id)
        if loc is not None:
            n = self._read_at(loc[0], loc[1], zero_copy=zero_copy)
        else:
            n = self._read_tombstoned(needle_id) if read_deleted else None
            if n is None:
                raise NotFoundError(
                    f"needle {needle_id:x} not found in volume {self.id}"
                )
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(f"cookie mismatch for needle {needle_id:x}")
        return n

    def _tombstoned_location(self, needle_id: int) -> tuple[int, int] | None:
        """(offset, original size) of a deleted-but-not-vacuumed needle:
        the map keeps the original record's offset under the tombstone,
        and the record's own header carries the pre-delete size."""
        raw = self.nm.get_any(needle_id)
        if raw is None:
            return None
        hdr = os.pread(self._dat.fileno(), t.NEEDLE_HEADER_SIZE, raw[0])
        if len(hdr) < t.NEEDLE_HEADER_SIZE:
            return None
        _, _, size = Needle.parse_header(hdr)
        if not t.size_is_valid(size):
            return None
        return raw[0], size

    def deleted_needle_size(self, needle_id: int) -> int | None:
        """Size a ?readDeleted=true read would return (throttle hints)."""
        loc = self._tombstoned_location(needle_id)
        return loc[1] if loc else None

    def _read_tombstoned(self, needle_id: int) -> Needle | None:
        """Deleted-but-not-vacuumed needle (?readDeleted=true, reference
        ReadOption.ReadDeleted)."""
        loc = self._tombstoned_location(needle_id)
        if loc is None:
            return None
        return self._read_at(loc[0], loc[1])

    def has(self, needle_id: int) -> bool:
        return self.nm.has(needle_id)

    # -- stats / lifecycle ---------------------------------------------------

    @property
    def content_size(self) -> int:
        self._dat.flush()
        return os.path.getsize(self.dat_path)

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

    def sync(self) -> None:
        with self._lock:
            self._dat.flush()
            os.fsync(self._dat.fileno())
            self._idx.flush()
            os.fsync(self._idx.fileno())

    def close(self) -> None:
        with self._lock:
            clean = not self._dat.closed or not self._idx.closed
            if not self._dat.closed:
                self._dat.flush()
                self._dat.close()
            if not self._idx.closed:
                self._idx.flush()
                self._idx.close()
            if clean and os.path.exists(self.note_path):
                os.remove(self.note_path)

    def destroy(self) -> None:
        self.close()
        for p in (self.dat_path, self.idx_path, self.note_path,
                  self.base_name(self.dir, self.id, self.collection) + ".vif"):
            if os.path.exists(p):
                os.remove(p)
