"""Path-prefix storage rules: the filer's /etc/seaweedfs/filer.conf.

Reference: weed/filer/filer_conf.go — per-prefix overrides (collection,
replication, ttl, disk type, fsync) stored as a conf entry inside the
filer namespace itself, consulted on every auto-chunk assign and editable
live via the shell's fs.configure.  The reference persists protobuf
FilerConf; here the document is JSON for the same content.

A copy of seaweedfs_tpu/filer/path_conf.py; it imports nothing of that
package.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

CONF_DIR = "/etc/seaweedfs"
CONF_NAME = "filer.conf"
CONF_PATH = f"{CONF_DIR}/{CONF_NAME}"


@dataclass
class PathConf:
    location_prefix: str
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    disk_type: str = ""
    read_only: bool = False


@dataclass
class FilerConf:
    locations: list[PathConf] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "FilerConf":
        if not blob:
            return cls()
        doc = json.loads(blob)
        return cls(
            locations=[PathConf(**loc) for loc in doc.get("locations", [])]
        )

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"locations": [asdict(l) for l in self.locations]}, indent=2
        ).encode()

    def upsert(self, rule: PathConf) -> None:
        self.locations = [
            l for l in self.locations
            if l.location_prefix != rule.location_prefix
        ]
        self.locations.append(rule)
        self.locations.sort(key=lambda l: l.location_prefix)

    def delete(self, location_prefix: str) -> bool:
        before = len(self.locations)
        self.locations = [
            l for l in self.locations if l.location_prefix != location_prefix
        ]
        return len(self.locations) != before

    def match(self, path: str) -> PathConf | None:
        """Longest matching location_prefix wins (filer_conf.go MatchStorageRule)."""
        best = None
        for l in self.locations:
            if path.startswith(l.location_prefix):
                if best is None or len(l.location_prefix) > len(
                    best.location_prefix
                ):
                    best = l
        return best


async def save_conf_entry(stub, directory: str, name: str, blob: bytes,
                          mode: int = 0o644) -> None:
    """Persist a small config document as a content entry via a filer
    stub — shared by fs.configure, s3.configure, s3.bucket.quota.check
    and s3.circuitbreaker so the write shape can't drift."""
    import time

    from ..pb import filer_pb2

    resp = await stub.CreateEntry(
        filer_pb2.CreateEntryRequest(
            directory=directory,
            entry=filer_pb2.Entry(
                name=name,
                content=blob,
                attributes=filer_pb2.FuseAttributes(
                    file_mode=mode,
                    mtime=int(time.time()),
                    file_size=len(blob),
                ),
            ),
        ),
        timeout=30.0,  # a small config write is one round-trip (GL114)
    )
    if resp.error:
        raise ValueError(resp.error)
