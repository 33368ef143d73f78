"""Topology node tree: Topology → DataCenter → Rack → DataNode.

A copy of seaweedfs_tpu/topology/node.py (host code, no device work).

Reference: weed/topology/node.go (277), data_center.go, rack.go,
data_node.go (298), disk.go (271).  Re-designed: instead of the reference's
interface-with-embedded-struct pattern and channel-based accounting, this is
a plain tree where capacity rolls up on demand — the counts are derived from
the authoritative per-DataNode volume maps rather than incrementally
adjusted (the reference's adjust* methods are a frequent source of drift it
has to re-sync anyway).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

from ..storage.ec import ShardBits
from ..storage.store import EcShardMessage, VolumeMessage


@dataclass(frozen=True)
class DataNodeId:
    ip: str
    port: int

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def __str__(self) -> str:
        return self.url


@dataclass
class EcShardInfo:
    """One EC volume's shards on one node (ec_volume_info.go)."""

    vid: int
    collection: str
    shard_bits: ShardBits
    disk_type: str = "hdd"


class DataNode:
    def __init__(
        self,
        ip: str,
        port: int,
        public_url: str = "",
        grpc_port: int = 0,
        rack: "Rack | None" = None,
    ):
        self.id = DataNodeId(ip, port)
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or port + 10000
        self.public_url = public_url or self.id.url
        self.rack = rack
        self.volumes: dict[int, VolumeMessage] = {}
        self.ec_shards: dict[int, EcShardInfo] = {}
        self.max_volume_counts: dict[str, int] = {}
        self.last_seen = time.time()
        # multi-process pod membership ("" = not in a pod; the port's
        # servers are never in one).  A rack-like failure domain: pod
        # members degrade together when one dies, so placement must not
        # treat two pod members as independent the way two arbitrary
        # nodes are.
        self.mesh_pod = ""

    @property
    def url(self) -> str:
        return self.id.url

    @property
    def grpc_url(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def max_volume_count(self, disk_type: str = "") -> int:
        if disk_type:
            return self.max_volume_counts.get(disk_type, 0)
        return sum(self.max_volume_counts.values())

    def volume_count(self, disk_type: str = "") -> int:
        n = sum(
            1 for v in self.volumes.values() if not disk_type or v.disk_type == disk_type
        )
        ec = sum(
            s.shard_bits.count()
            for s in self.ec_shards.values()
            if not disk_type or s.disk_type == disk_type
        )
        from ..storage.ec import TOTAL_SHARDS

        return n + (ec + TOTAL_SHARDS - 1) // TOTAL_SHARDS

    def free_slots(self, disk_type: str = "") -> int:
        return self.max_volume_count(disk_type) - self.volume_count(disk_type)

    # -- registration (data_node.go UpdateVolumes/DeltaUpdateVolumes) --------

    def set_volumes(self, volumes: list[VolumeMessage]) -> tuple[list, list]:
        """Full sync; -> (new, deleted) VolumeMessages vs the prior view."""
        incoming = {v.id: v for v in volumes}
        new = [v for vid, v in incoming.items() if vid not in self.volumes]
        deleted = [v for vid, v in self.volumes.items() if vid not in incoming]
        self.volumes = incoming
        return new, deleted

    def update_volumes(self, new: list[VolumeMessage], deleted: list[VolumeMessage]):
        for v in new:
            self.volumes[v.id] = v
        for v in deleted:
            self.volumes.pop(v.id, None)

    def set_ec_shards(self, shards: list[EcShardMessage]) -> tuple[list, list]:
        incoming = {
            s.id: EcShardInfo(s.id, s.collection, ShardBits(s.ec_index_bits), s.disk_type)
            for s in shards
        }
        new, deleted = [], []
        for vid, info in incoming.items():
            prev = self.ec_shards.get(vid)
            if prev is None or int(prev.shard_bits) != int(info.shard_bits):
                new.append(info)
                # shard ids that vanished from the node's bits must be
                # unregistered too, or a reconnect full-sync leaves the
                # master serving stale EC shard locations
                if prev is not None:
                    gone = prev.shard_bits.minus(info.shard_bits)
                    if gone.count():
                        deleted.append(replace(prev, shard_bits=gone))
        for vid, info in self.ec_shards.items():
            if vid not in incoming:
                deleted.append(info)
        self.ec_shards = incoming
        return new, deleted

    def update_ec_shards(
        self, new: list[EcShardMessage], deleted: list[EcShardMessage]
    ) -> tuple[list[EcShardInfo], list[EcShardInfo]]:
        added_infos, removed_infos = [], []
        for s in new:
            cur = self.ec_shards.get(s.id)
            bits = ShardBits(s.ec_index_bits)
            if cur is None:
                cur = EcShardInfo(s.id, s.collection, bits, s.disk_type)
                self.ec_shards[s.id] = cur
            else:
                cur.shard_bits = cur.shard_bits.plus(bits)
            added_infos.append(EcShardInfo(s.id, s.collection, bits, s.disk_type))
        for s in deleted:
            cur = self.ec_shards.get(s.id)
            if cur is None:
                continue
            bits = ShardBits(s.ec_index_bits)
            cur.shard_bits = cur.shard_bits.minus(bits)
            if cur.shard_bits.count() == 0:
                del self.ec_shards[s.id]
            removed_infos.append(EcShardInfo(s.id, s.collection, bits, s.disk_type))
        return added_infos, removed_infos

    def __repr__(self) -> str:
        return f"DataNode({self.url}, vols={len(self.volumes)})"


class Rack:
    def __init__(self, name: str, data_center: "DataCenter"):
        self.name = name
        self.data_center = data_center
        self.nodes: dict[str, DataNode] = {}

    def get_or_create_node(
        self, ip: str, port: int, public_url: str = "", grpc_port: int = 0
    ) -> DataNode:
        key = f"{ip}:{port}"
        node = self.nodes.get(key)
        if node is None:
            node = DataNode(ip, port, public_url, grpc_port, rack=self)
            self.nodes[key] = node
        node.last_seen = time.time()
        return node

    def data_nodes(self) -> list[DataNode]:
        return list(self.nodes.values())

    def free_slots(self, disk_type: str = "") -> int:
        return sum(n.free_slots(disk_type) for n in self.nodes.values())


class DataCenter:
    def __init__(self, name: str):
        self.name = name
        self.racks: dict[str, Rack] = {}

    def get_or_create_rack(self, name: str) -> Rack:
        rack = self.racks.get(name)
        if rack is None:
            rack = Rack(name, self)
            self.racks[name] = rack
        return rack

    def data_nodes(self) -> list[DataNode]:
        return [n for r in self.racks.values() for n in r.data_nodes()]

    def free_slots(self, disk_type: str = "") -> int:
        return sum(r.free_slots(disk_type) for r in self.racks.values())
