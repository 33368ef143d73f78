"""vidMap: volume id -> server locations, updated from master broadcasts
(a copy of seaweedfs_tpu/wdclient/vid_map.py).

Reference: weed/wdclient/vid_map.go:37-120 — vid/ecVid location maps with
same-DC read preference.  The reference keeps a 5-deep history of maps to
dodge a data race; here a plain dict under a lock suffices (no shared
iteration without the lock).
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class Location:
    url: str
    public_url: str = ""
    grpc_port: int = 0
    data_center: str = ""

    @property
    def grpc_address(self) -> str:
        host = self.url.rsplit(":", 1)[0]
        port = self.grpc_port or int(self.url.rsplit(":", 1)[1]) + 10000
        return f"{host}:{port}"


class VidMap:
    def __init__(self, data_center: str = ""):
        self.data_center = data_center
        self._lock = threading.RLock()
        self._vid2locations: dict[int, list[Location]] = {}
        self._ecvid2locations: dict[int, list[Location]] = {}

    def lookup(self, vid: int) -> list[Location]:
        """Same-DC locations first, randomized within each tier
        (vid_map.go:65-90)."""
        with self._lock:
            locs = list(
                self._vid2locations.get(vid, []) or self._ecvid2locations.get(vid, [])
            )
        if not locs:
            return []
        random.shuffle(locs)
        if self.data_center:
            locs.sort(key=lambda l: l.data_center != self.data_center)
        return locs

    def lookup_file_id(self, fid: str) -> list[str]:
        vid = int(fid.split(",")[0])
        return [f"http://{l.url}/{fid}" for l in self.lookup(vid)]

    def add_location(self, vid: int, loc: Location, is_ec: bool = False) -> None:
        with self._lock:
            m = self._ecvid2locations if is_ec else self._vid2locations
            cur = m.setdefault(vid, [])
            if all(l.url != loc.url for l in cur):
                cur.append(loc)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            for m in (self._vid2locations, self._ecvid2locations):
                if vid in m:
                    m[vid] = [l for l in m[vid] if l.url != url]
                    if not m[vid]:
                        del m[vid]

    def delete_server(self, url: str) -> None:
        with self._lock:
            for m in (self._vid2locations, self._ecvid2locations):
                for vid in list(m):
                    m[vid] = [l for l in m[vid] if l.url != url]
                    if not m[vid]:
                        del m[vid]

    def __len__(self) -> int:
        with self._lock:
            return len(self._vid2locations) + len(self._ecvid2locations)
