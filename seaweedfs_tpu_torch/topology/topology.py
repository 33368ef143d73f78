"""Topology: the master's root data structure.

A copy of seaweedfs_tpu/topology/topology.py (host code, no device work).

Reference: weed/topology/topology.go (357), topology_ec.go (177),
collection.go, master_grpc_server.go heartbeat intake (:61-170).  Holds the
DC/rack/node tree, per-collection VolumeLayouts, the EC shard map, and the
sequencer; processes heartbeats (full + incremental) and answers
assign/lookup queries.

The reference spreads this over goroutine channels + raft; here Topology is
a plain object guarded by one RLock — the asyncio master server serializes
mutations on its event loop and calls the blocking sequencer off-thread.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from ..storage import types as t
from ..storage.ec import ShardBits, TOTAL_SHARDS
from ..storage.store import EcShardMessage, HeartbeatState, VolumeMessage
from .node import DataCenter, DataNode, EcShardInfo
from .sequence import MemorySequencer
from .volume_growth import VolumeGrowOption, VolumeGrowth
from .volume_layout import VolumeLayout


@dataclass
class Collection:
    name: str
    layouts: dict[tuple, VolumeLayout] = field(default_factory=dict)

    def get_layout(
        self,
        rp: t.ReplicaPlacement,
        ttl: t.TTL,
        disk_type: str,
        volume_size_limit: int,
    ) -> VolumeLayout:
        key = (str(rp), str(ttl), disk_type)
        vl = self.layouts.get(key)
        if vl is None:
            vl = VolumeLayout(rp, ttl, disk_type, volume_size_limit)
            self.layouts[key] = vl
        return vl


@dataclass
class EcShardLocations:
    """vid -> [nodes holding each shard id] (topology_ec.go EcShardLocations)."""

    collection: str
    locations: list[list[DataNode]] = field(
        default_factory=lambda: [[] for _ in range(TOTAL_SHARDS)]
    )

    def add(self, shard_id: int, node: DataNode) -> None:
        if all(n.url != node.url for n in self.locations[shard_id]):
            self.locations[shard_id].append(node)

    def remove(self, shard_id: int, node: DataNode) -> None:
        self.locations[shard_id] = [
            n for n in self.locations[shard_id] if n.url != node.url
        ]

    def is_empty(self) -> bool:
        return all(not loc for loc in self.locations)


class Topology:
    def __init__(
        self,
        volume_size_limit: int = 30 * 1024**3,
        sequencer: MemorySequencer | None = None,
        pulse_seconds: int = 5,
    ):
        self.volume_size_limit = volume_size_limit
        self.sequencer = sequencer or MemorySequencer()
        self.pulse_seconds = pulse_seconds
        self.data_centers: dict[str, DataCenter] = {}
        self.collections: dict[str, Collection] = {}
        self.ec_shard_map: dict[int, EcShardLocations] = {}
        self.max_volume_id = 0
        self.growth = VolumeGrowth()
        self._lock = threading.RLock()

    # -- tree ----------------------------------------------------------------

    def get_or_create_data_center(self, name: str) -> DataCenter:
        with self._lock:
            dc = self.data_centers.get(name or "DefaultDataCenter")
            if dc is None:
                dc = DataCenter(name or "DefaultDataCenter")
                self.data_centers[dc.name] = dc
            return dc

    def get_or_create_node(
        self,
        dc: str,
        rack: str,
        ip: str,
        port: int,
        public_url: str = "",
        grpc_port: int = 0,
    ) -> DataNode:
        with self._lock:
            return (
                self.get_or_create_data_center(dc)
                .get_or_create_rack(rack or "DefaultRack")
                .get_or_create_node(ip, port, public_url, grpc_port)
            )

    def data_nodes(self) -> list[DataNode]:
        return [n for dc in self.data_centers.values() for n in dc.data_nodes()]

    def find_node(self, url: str) -> DataNode | None:
        for n in self.data_nodes():
            if n.url == url:
                return n
        return None

    # -- heartbeat intake (master_grpc_server.go:61-170) ---------------------

    def sync_node(
        self, node: DataNode, hs: HeartbeatState
    ) -> tuple[list, list, list, list]:
        """Full registration: reconcile the node's volume + EC view.
        Returns (new_vids, deleted_vids, new_ec_vids, deleted_ec_vids) for
        client broadcast."""
        with self._lock:
            node.max_volume_counts = dict(hs.max_volume_counts)
            node.last_seen = time.time()
            new_v, deleted_v = node.set_volumes(hs.volumes)
            for v in hs.volumes:
                self._register_volume(v, node)
            for v in deleted_v:
                self._unregister_volume(v, node)
            self.max_volume_id = max(
                [self.max_volume_id] + [v.id for v in hs.volumes]
            )

            new_ec, deleted_ec = node.set_ec_shards(hs.ec_shards)
            for info in new_ec:
                self._register_ec_shards(info, node)
            for info in deleted_ec:
                self._unregister_ec_shards(info, node)
            return (
                [v.id for v in new_v],
                [v.id for v in deleted_v],
                [s.vid for s in new_ec],
                [s.vid for s in deleted_ec],
            )

    def incremental_sync_node(
        self,
        node: DataNode,
        new_volumes: list[VolumeMessage],
        deleted_volumes: list[VolumeMessage],
        new_ec: list[EcShardMessage] = (),
        deleted_ec: list[EcShardMessage] = (),
    ) -> None:
        with self._lock:
            node.update_volumes(new_volumes, deleted_volumes)
            for v in new_volumes:
                self._register_volume(v, node)
                self.max_volume_id = max(self.max_volume_id, v.id)
            for v in deleted_volumes:
                self._unregister_volume(v, node)
            added, removed = node.update_ec_shards(list(new_ec), list(deleted_ec))
            for info in added:
                self._register_ec_shards(info, node)
            for info in removed:
                self._unregister_ec_shards(info, node)

    def unregister_node(self, node: DataNode) -> tuple[list[int], list[int]]:
        """Node died: drop all its volumes/EC shards from layouts
        (master_grpc_server.go:63-94).  -> (deleted_vids, deleted_ec_vids)."""
        with self._lock:
            for v in list(node.volumes.values()):
                self._unregister_volume(v, node)
            for info in list(node.ec_shards.values()):
                self._unregister_ec_shards(info, node)
            if node.rack:
                node.rack.nodes.pop(node.url, None)
            return [v.id for v in node.volumes.values()], list(node.ec_shards)

    # -- volume registry -----------------------------------------------------

    def _layout_for(self, v: VolumeMessage) -> VolumeLayout:
        rp = t.ReplicaPlacement.from_byte(v.replica_placement)
        ttl = t.TTL.from_bytes(int(v.ttl).to_bytes(2, "big"))
        col = self.collections.setdefault(v.collection, Collection(v.collection))
        return col.get_layout(rp, ttl, v.disk_type or "hdd", self.volume_size_limit)

    def _register_volume(self, v: VolumeMessage, node: DataNode) -> None:
        vl = self._layout_for(v)
        vl.register(v, node)  # also derives oversized/crowded from v.size

    def _unregister_volume(self, v: VolumeMessage, node: DataNode) -> None:
        vl = self._layout_for(v)
        vl.unregister(v.id, node)
        col = self.collections.get(v.collection)
        if col and all(not l.vid2location for l in col.layouts.values()):
            del self.collections[v.collection]

    # -- EC registry (topology_ec.go) ----------------------------------------

    def _register_ec_shards(self, info: EcShardInfo, node: DataNode) -> None:
        locs = self.ec_shard_map.setdefault(
            info.vid, EcShardLocations(info.collection)
        )
        for sid in info.shard_bits.shard_ids():
            locs.add(sid, node)

    def _unregister_ec_shards(self, info: EcShardInfo, node: DataNode) -> None:
        locs = self.ec_shard_map.get(info.vid)
        if locs is None:
            return
        for sid in info.shard_bits.shard_ids():
            locs.remove(sid, node)
        if locs.is_empty():
            del self.ec_shard_map[info.vid]

    def lookup_ec_shards(self, vid: int) -> EcShardLocations | None:
        return self.ec_shard_map.get(vid)

    # -- assign / lookup (master_grpc_server_volume.go:80-240) ---------------

    def pick_for_write(
        self, count: int, option: VolumeGrowOption
    ) -> tuple[str, int, list[DataNode]]:
        """-> (fid, count_reserved, replica nodes)."""
        col = self.collections.get(option.collection)
        if col is None:
            raise LookupError(f"no writable volumes for {option.collection!r}")
        vl = col.get_layout(
            option.replica_placement,
            option.ttl,
            option.disk_type,
            self.volume_size_limit,
        )
        vid, nodes = vl.pick_for_write(
            count, option.preferred_data_center, option.preferred_node
        )
        first = self.sequencer.next_ids(count)
        cookie = int.from_bytes(os.urandom(4), "big")
        fid = t.format_fid(vid, first, cookie)
        return fid, count, nodes

    def lookup_volume(self, collection: str, vid: int) -> list[DataNode]:
        """Replica locations for a volume id; searches all collections when
        the caller doesn't know which (Lookup topology.go:190-220)."""
        cols = (
            [self.collections[collection]]
            if collection in self.collections
            else list(self.collections.values())
        )
        for col in cols:
            for vl in col.layouts.values():
                nodes = vl.lookup(vid)
                if nodes:
                    return nodes
        # EC volumes answer lookups too (Lookup falls through to ec map)
        locs = self.ec_shard_map.get(vid)
        if locs:
            seen, out = set(), []
            for shard_nodes in locs.locations:
                for n in shard_nodes:
                    if n.url not in seen:
                        seen.add(n.url)
                        out.append(n)
            return out
        return []

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def layouts(self) -> list[tuple[str, VolumeLayout]]:
        return [
            (col.name, vl)
            for col in self.collections.values()
            for vl in col.layouts.values()
        ]

    # -- growth (AutomaticGrowByType volume_growth.go:60-110) ----------------

    def grow_volumes(
        self,
        option: VolumeGrowOption,
        count: int,
        allocate_fn,
    ) -> list[int]:
        """Plan placement and call `allocate_fn(node, vid, option)` for each
        replica; registers nothing — the volume servers report the new
        volumes on their next heartbeat delta.  Returns new vids."""
        grown = []
        for _ in range(count):
            servers = self.growth.find_empty_slots(self.data_centers, option)
            vid = self.next_volume_id()
            for node in servers:
                allocate_fn(node, vid, option)
            grown.append(vid)
        return grown

    # -- introspection (used by shell volume.list / master /dir/status) ------

    def to_info(self) -> dict:
        """Topology snapshot as plain data (master_pb.TopologyInfo shape)."""
        return {
            "max_volume_id": self.max_volume_id,
            "data_centers": [
                {
                    "id": dc.name,
                    "racks": [
                        {
                            "id": r.name,
                            "nodes": [
                                {
                                    "id": n.url,
                                    "public_url": n.public_url,
                                    "grpc_port": n.grpc_port,
                                    "volumes": [vars(v) for v in n.volumes.values()],
                                    "ec_shards": [
                                        {
                                            "id": s.vid,
                                            "collection": s.collection,
                                            "ec_index_bits": int(s.shard_bits),
                                            "disk_type": s.disk_type,
                                        }
                                        for s in n.ec_shards.values()
                                    ],
                                    "max_volume_counts": n.max_volume_counts,
                                    # host failure domain ("" = not
                                    # in a multi-controller pod)
                                    "mesh_pod": n.mesh_pod,
                                }
                                for n in r.data_nodes()
                            ],
                        }
                        for r in dc.racks.values()
                    ],
                }
                for dc in self.data_centers.values()
            ],
        }
