"""DiskLocation: one data directory holding volumes and EC shards.

Port of seaweedfs_tpu/storage/disk_location.py (reference:
weed/storage/disk_location.go + disk_location_ec.go).  A location scans
its directory at startup, loads every `.dat`/`.idx` pair into a Volume and
every `.ecx` (plus any `.ecNN` shard files) into an EcVolume, and answers
free-slot questions for placement decisions, per disk type (which the
heartbeat reports).  Tiered volumes (a `.vif` naming remote files), the
persistent needle maps, the free-space floor and the directory's uuid
file are ROADMAP A4c.
"""
from __future__ import annotations

import os
import re

from .ec import TOTAL_SHARDS, EcVolume
from .volume import Volume

_EC_SHARD_RE = re.compile(r"\.ec(\d{2})$")


def parse_base_name(stem: str) -> tuple[str, int] | None:
    """`<collection>_<vid>` or `<vid>` -> (collection, vid); None if not a
    volume file stem (volumeIdFromPath disk_location.go:180-196)."""
    collection, _, vid_s = stem.rpartition("_")
    try:
        return collection, int(vid_s)
    except ValueError:
        return None


class DiskLocation:
    def __init__(
        self,
        directory: str,
        max_volume_count: int = 8,
        disk_type: str = "hdd",
    ):
        self.directory = os.path.abspath(directory)
        self.max_volume_count = max_volume_count
        # the heartbeat reports slots and volumes per disk type
        self.disk_type = disk_type
        os.makedirs(self.directory, exist_ok=True)
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}

    # -- discovery (loadExistingVolumes disk_location.go:209) ----------------

    def load_existing_volumes(self) -> None:
        names = sorted(os.listdir(self.directory))
        for name in names:
            if not name.endswith(".dat"):
                continue
            parsed = parse_base_name(name[: -len(".dat")])
            if parsed is None:
                continue
            collection, vid = parsed
            if vid in self.volumes:
                continue
            try:
                self.volumes[vid] = Volume(self.directory, vid, collection)
            except (ValueError, KeyError):
                continue  # bad superblock
        self._load_ec_volumes(names)

    def _load_ec_volumes(self, names: list[str]) -> None:
        """Mount every .ecx with whatever local .ecNN shards exist
        (loadAllEcShards disk_location_ec.go:106-160)."""
        shards: dict[tuple[str, int], list[int]] = {}
        for name in names:
            m = _EC_SHARD_RE.search(name)
            if not m:
                continue
            parsed = parse_base_name(name[: m.start()])
            if parsed is None:
                continue
            shards.setdefault(parsed, []).append(int(m.group(1)))
        for name in names:
            if not name.endswith(".ecx"):
                continue
            parsed = parse_base_name(name[: -len(".ecx")])
            if parsed is None:
                continue
            collection, vid = parsed
            if vid in self.ec_volumes:
                continue
            ev = EcVolume(self.directory, vid, collection)
            for sid in sorted(shards.get(parsed, [])):
                if sid < TOTAL_SHARDS:
                    ev.add_shard(sid)
            self.ec_volumes[vid] = ev

    # -- capacity ------------------------------------------------------------

    def volume_count(self) -> int:
        # EC shards occupy slots at shard granularity (store.go:254-268)
        ec_slots = sum(len(ev.shards) for ev in self.ec_volumes.values())
        return len(self.volumes) + (ec_slots + TOTAL_SHARDS - 1) // TOTAL_SHARDS

    def free_slots(self) -> int:
        return max(0, self.max_volume_count - self.volume_count())

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        for v in self.volumes.values():
            v.close()
        for ev in self.ec_volumes.values():
            ev.close()
        self.volumes.clear()
        self.ec_volumes.clear()
