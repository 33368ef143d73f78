"""Vacuum: reclaim deleted-needle space by copying live records.

The port of seaweedfs_tpu/storage/vacuum.py (reference behavior:
weed/storage/volume_vacuum.go).  compact() copies live needles into shadow
files (.cpd/.cpx); commit() applies `makeupDiff` — index entries appended
since the snapshot (writes that raced the copy) are replayed onto the
shadow — and atomically renames.  The compaction revision increments in
the new superblock.

Under `-index sqlite` compact() also pre-builds the shadow needle-map
database over the .cpx off-lock (cpx + ".sdx"), and commit() swaps it in
as the live .sdx; the makeupDiff entries fold in by its watermark's tail
replay.  Every other map kind is rebuilt fresh at the swap.

A caller that streams parity from the .dat (the ingest plane) must
invalidate it before compact(): every needle's offset moves.
Store.compact_volume / commit_compact do, for Store.vacuum_volume and the
volume server's Vacuum* rpcs alike.
"""
from __future__ import annotations

import dataclasses
import os

from . import idx as idx_mod
from . import needle as needle_mod
from . import types as t
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .volume import Volume, _ReadState


def compact(v: Volume) -> tuple[str, str, int, str | None]:
    """Phase 1: copy live needles to .cpd/.cpx.  Returns (cpd, cpx,
    idx_snapshot_bytes, shadow_db) — the snapshot marks where makeupDiff
    starts; shadow_db is a pre-built persistent needle map over the .cpx
    (built off-lock here so commit doesn't replay millions of entries
    under the write lock), or None for the other map kinds."""
    base = Volume.base_name(v.dir, v.id, v.collection)
    cpd, cpx = base + ".cpd", base + ".cpx"
    v.sync()
    idx_snapshot = os.path.getsize(v.idx_path)

    # The live superblock is untouched until commit(); only the shadow file
    # carries the bumped revision.
    new_sb = dataclasses.replace(
        v.super_block, compaction_revision=v.super_block.compaction_revision + 1
    )
    with open(cpd, "wb") as dat, open(cpx, "wb") as xf:
        dat.write(new_sb.to_bytes())
        for rec_offset, n in v.scan():
            loc = v.nm.get(n.id)
            if loc is None or loc[0] != rec_offset:
                # deleted, or superseded by a later rewrite of the same id
                # (the reference compares nv.Offset to the scan offset,
                # volume_vacuum.go Compact copy loop)
                continue
            offset = dat.tell()
            dat.write(n.to_bytes(v.version))
            xf.write(idx_mod.pack_entry(n.id, offset, n.size))
    shadow_db = None
    if v.needle_map_kind == "persistent":
        from .needle_map_persistent import SqliteNeedleMap

        shadow_db = cpx + ".sdx"
        if os.path.exists(shadow_db):
            os.remove(shadow_db)
        SqliteNeedleMap(shadow_db, cpx, v.version).close()
    return cpd, cpx, idx_snapshot, shadow_db


def commit(v: Volume, cpd: str, cpx: str, idx_snapshot: int,
           shadow_db: str | None = None) -> None:
    """Phase 2: replay post-snapshot index entries onto the shadow files
    (makeupDiff, volume_vacuum.go:200), then rename over the originals."""
    with v._lock:
        v.sync()
        with open(v.idx_path, "rb") as f:
            f.seek(idx_snapshot)
            diff = f.read()
        if diff:
            ids, offs, sizes = idx_mod.parse_buffer(diff)
            with open(cpd, "r+b") as dat, open(cpx, "ab") as xf, open(
                v.dat_path, "rb"
            ) as old:
                for i in range(len(ids)):
                    nid, off, size = int(ids[i]), int(offs[i]), int(sizes[i])
                    if t.size_is_valid(size):
                        # racing write: copy the record across
                        total = needle_mod.actual_size(size, v.version)
                        old.seek(off)
                        record = old.read(total)
                        dat.seek(0, os.SEEK_END)
                        new_off = dat.tell()
                        dat.write(record)
                        xf.write(idx_mod.pack_entry(nid, new_off, size))
                    else:
                        xf.write(
                            idx_mod.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE)
                        )
        # a configure may have changed the replica placement since the
        # shadow superblock was snapshotted off-lock in compact(); the
        # live in-memory value is authoritative and must survive the swap
        live_rp = v.super_block.replica_placement
        v._idx.close()
        os.replace(cpd, v.dat_path)
        os.replace(cpx, v.idx_path)
        if shadow_db is not None:
            # the pre-built map becomes the live .sdx; readers holding the
            # old map keep the old (now unlinked) inode open
            os.replace(shadow_db, v.sdx_path)
        with open(v.dat_path, "rb") as f:
            v.super_block = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        if str(v.super_block.replica_placement) != str(live_rp):
            v.super_block.replica_placement = live_rp
            with open(v.dat_path, "r+b") as f:
                f.write(v.super_block.to_bytes())
        # Publish the new (dat, nm) pair as one atomic reference swap; the
        # old dat file object is deliberately NOT closed here — lock-free
        # readers that captured the previous _ReadState keep preading the
        # old (pre-rename) inode and the fd closes via refcounting when the
        # last of them finishes.
        v._state = _ReadState(open(v.dat_path, "r+b"),
                              v._build_map(fresh=shadow_db is None))
        v._idx = open(v.idx_path, "ab")


def vacuum(v: Volume) -> float:
    """Full compact+commit.  Returns the garbage ratio that was reclaimed."""
    ratio = v.garbage_ratio
    commit(v, *compact(v))
    return ratio
