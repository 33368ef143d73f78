"""Volume superblock: the 8-byte `.dat` header.

Byte-compatible with the reference (weed/storage/super_block/super_block.go:16-23):
  byte 0: needle version (1..3)
  byte 1: replica placement (XYZ digits packed decimal)
  bytes 2-3: TTL
  bytes 4-5: compaction revision (u16be)
  bytes 6-7: extra size (reserved; protobuf extra unsupported -> 0)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import needle as needle_mod
from . import types as t

SUPER_BLOCK_SIZE = 8


@dataclass
class SuperBlock:
    version: int = needle_mod.CURRENT_VERSION
    replica_placement: t.ReplicaPlacement = field(default_factory=t.ReplicaPlacement)
    ttl: t.TTL = field(default_factory=t.TTL)
    compaction_revision: int = 0

    def to_bytes(self) -> bytes:
        return (
            bytes([self.version, self.replica_placement.to_byte()])
            + self.ttl.to_bytes()
            + struct.pack(">H", self.compaction_revision)
            + b"\x00\x00"
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock truncated")
        version = b[0]
        if version not in (1, 2, 3):
            raise ValueError(f"unsupported volume version {version}")
        extra_size = struct.unpack(">H", b[6:8])[0]
        if extra_size:
            raise ValueError("superblock extra not supported")
        return cls(
            version=version,
            replica_placement=t.ReplicaPlacement.from_byte(b[1]),
            ttl=t.TTL.from_bytes(b[2:4]),
            compaction_revision=struct.unpack(">H", b[4:6])[0],
        )
