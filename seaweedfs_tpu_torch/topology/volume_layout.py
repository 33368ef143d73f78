"""VolumeLayout: write-target selection per (collection, rp, ttl, disk).

A copy of seaweedfs_tpu/topology/volume_layout.py (host code, no device work).

Reference: weed/topology/volume_layout.go (538 LoC).  Tracks which volume
ids live where, which are writable (enough replicas, not full/readonly),
and picks write targets.  The reference's `crowded`/`oversized` sets and
round-robin cursor are kept; the per-vid replica list is the authority.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from ..storage import types as t
from ..storage.store import VolumeMessage
from .node import DataNode


@dataclass
class VolumeLocationList:
    nodes: list[DataNode]

    def refresh(self) -> None:
        seen = set()
        out = []
        for n in self.nodes:
            if n.url not in seen:
                seen.add(n.url)
                out.append(n)
        self.nodes = out

    def __len__(self) -> int:
        return len(self.nodes)


class VolumeLayout:
    def __init__(
        self,
        rp: t.ReplicaPlacement,
        ttl: t.TTL,
        disk_type: str = "hdd",
        volume_size_limit: int = 30 * 1024**3,
    ):
        self.rp = rp
        self.ttl = ttl
        self.disk_type = disk_type
        self.volume_size_limit = volume_size_limit
        self.vid2location: dict[int, VolumeLocationList] = {}
        self.writables: list[int] = []
        # read-only is tracked per replica (last-reporter-wins on a flat set
        # would let one writable replica mask a still-read-only one), plus a
        # layout-wide admin/vacuum override
        self.readonly_nodes: dict[int, set[str]] = {}
        self.readonly_admin: set[int] = set()
        # per-replica sizes; oversized/crowded derive from the LARGEST
        # replica, so a freshly-vacuumed small replica can't reopen a vid
        # whose other replica is still at the limit
        self.sizes: dict[int, dict[str, int]] = {}
        self.oversized: set[int] = set()
        self.crowded: set[int] = set()
        self._cursor = random.randrange(1 << 30)
        self._lock = threading.RLock()

    # -- registration (volume_layout.go RegisterVolume/UnRegisterVolume) -----

    def register(self, v: VolumeMessage, node: DataNode) -> None:
        with self._lock:
            loc = self.vid2location.setdefault(v.id, VolumeLocationList([]))
            if all(n.url != node.url for n in loc.nodes):
                loc.nodes.append(node)
            # Heartbeats are the authority in BOTH directions: a replica that
            # was vacuumed back under the limit or marked writable again must
            # return to the pool (reference ensureCorrectWritables) — but only
            # for ITS OWN read-only bit.
            urls = self.readonly_nodes.setdefault(v.id, set())
            if v.read_only:
                urls.add(node.url)
            else:
                urls.discard(node.url)
            if not urls:
                del self.readonly_nodes[v.id]
            self.sizes.setdefault(v.id, {})[node.url] = v.size
            self._derive_size_state(v.id)  # rechecks writability

    def unregister(self, vid: int, node: DataNode) -> None:
        with self._lock:
            loc = self.vid2location.get(vid)
            if loc is None:
                return
            loc.nodes = [n for n in loc.nodes if n.url != node.url]
            urls = self.readonly_nodes.get(vid)
            if urls is not None:
                urls.discard(node.url)
                if not urls:
                    del self.readonly_nodes[vid]
            sizes = self.sizes.get(vid)
            if sizes is not None:
                sizes.pop(node.url, None)
                if not sizes:
                    del self.sizes[vid]
            if not loc.nodes:
                del self.vid2location[vid]
                self._remove_writable(vid)
                self.readonly_admin.discard(vid)
                self.oversized.discard(vid)
                self.crowded.discard(vid)
            else:
                self._derive_size_state(vid)

    def _enough_copies(self, vid: int) -> bool:
        loc = self.vid2location.get(vid)
        return loc is not None and len(loc) >= self.rp.copy_count

    def is_readonly(self, vid: int) -> bool:
        return vid in self.readonly_admin or bool(self.readonly_nodes.get(vid))

    def _recheck_writable(self, vid: int) -> None:
        ok = (
            self._enough_copies(vid)
            and not self.is_readonly(vid)
            and vid not in self.oversized
        )
        if ok:
            if vid not in self.writables:
                self.writables.append(vid)
        else:
            self._remove_writable(vid)

    def _remove_writable(self, vid: int) -> None:
        if vid in self.writables:
            self.writables.remove(vid)

    def set_readonly(self, vid: int, read_only: bool) -> None:
        """Layout-wide admin/vacuum override, independent of what replicas
        report in heartbeats."""
        with self._lock:
            if read_only:
                self.readonly_admin.add(vid)
            else:
                self.readonly_admin.discard(vid)
            self._recheck_writable(vid)

    def _derive_size_state(self, vid: int) -> None:
        sizes = self.sizes.get(vid)
        mx = max(sizes.values()) if sizes else 0
        if mx >= self.volume_size_limit:
            self.oversized.add(vid)
        else:
            self.oversized.discard(vid)
        if mx >= self.volume_size_limit * 0.9:
            self.crowded.add(vid)
        else:
            self.crowded.discard(vid)
        self._recheck_writable(vid)

    # -- write selection (PickForWrite volume_layout.go:281-320) -------------

    def pick_for_write(
        self, count: int = 1, data_center: str = "", data_node: str = ""
    ) -> tuple[int, list[DataNode]]:
        """-> (vid, replica locations); raises LookupError when nothing is
        writable under the constraints."""
        with self._lock:
            candidates = self.writables
            if data_center or data_node:
                candidates = [
                    vid
                    for vid in self.writables
                    if any(
                        (not data_center or self._dc_of(n) == data_center)
                        and (not data_node or n.url == data_node)
                        for n in self.vid2location[vid].nodes
                    )
                ]
            if not candidates:
                raise LookupError("no writable volumes")
            self._cursor += 1
            vid = candidates[self._cursor % len(candidates)]
            return vid, list(self.vid2location[vid].nodes)

    @staticmethod
    def _dc_of(node: DataNode) -> str:
        return node.rack.data_center.name if node.rack else ""

    def lookup(self, vid: int) -> list[DataNode]:
        loc = self.vid2location.get(vid)
        return list(loc.nodes) if loc else []

    def active_volume_count(self) -> int:
        return len(self.writables)

    def stats(self) -> dict:
        with self._lock:
            return {
                "writables": sorted(self.writables),
                "readonly": sorted(
                    self.readonly_admin | set(self.readonly_nodes)
                ),
                "oversized": sorted(self.oversized),
                "total": len(self.vid2location),
            }
