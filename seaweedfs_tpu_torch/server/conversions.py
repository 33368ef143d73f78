"""pb <-> internal dataclass conversions shared by master and volume servers
(a copy of seaweedfs_tpu/server/conversions.py over the port's messages)."""
from __future__ import annotations

from ..pb import master_pb2
from ..storage.store import EcShardMessage, HeartbeatState, VolumeMessage
from ..topology.node import DataNode


def volume_msg_to_pb(v: VolumeMessage) -> master_pb2.VolumeInformationMessage:
    return master_pb2.VolumeInformationMessage(
        id=v.id,
        size=v.size,
        collection=v.collection,
        file_count=v.file_count,
        delete_count=v.delete_count,
        deleted_byte_count=v.deleted_byte_count,
        read_only=v.read_only,
        replica_placement=v.replica_placement,
        version=v.version,
        ttl=v.ttl,
        disk_type=v.disk_type,
        modified_at_second=v.modified_at_second,
    )


def volume_msg_from_pb(p: master_pb2.VolumeInformationMessage) -> VolumeMessage:
    return VolumeMessage(
        id=p.id,
        size=p.size,
        collection=p.collection,
        file_count=p.file_count,
        delete_count=p.delete_count,
        deleted_byte_count=p.deleted_byte_count,
        read_only=p.read_only,
        replica_placement=p.replica_placement,
        version=p.version,
        ttl=p.ttl,
        disk_type=p.disk_type,
        modified_at_second=p.modified_at_second,
    )


def ec_msg_to_pb(e: EcShardMessage) -> master_pb2.VolumeEcShardInformationMessage:
    return master_pb2.VolumeEcShardInformationMessage(
        id=e.id,
        collection=e.collection,
        ec_index_bits=e.ec_index_bits,
        disk_type=e.disk_type,
    )


def ec_msg_from_pb(p: master_pb2.VolumeEcShardInformationMessage) -> EcShardMessage:
    return EcShardMessage(
        id=p.id,
        collection=p.collection,
        ec_index_bits=p.ec_index_bits,
        disk_type=p.disk_type,
    )


def heartbeat_state_from_pb(hb: master_pb2.Heartbeat) -> HeartbeatState:
    return HeartbeatState(
        volumes=[volume_msg_from_pb(v) for v in hb.volumes],
        ec_shards=[ec_msg_from_pb(e) for e in hb.ec_shards],
        max_volume_counts=dict(hb.max_volume_counts),
        has_no_volumes=hb.has_no_volumes,
        has_no_ec_shards=hb.has_no_ec_shards,
    )


def node_to_location(n: DataNode) -> master_pb2.Location:
    return master_pb2.Location(
        url=n.url,
        public_url=n.public_url,
        grpc_port=n.grpc_port,
        data_center=n.rack.data_center.name if n.rack else "",
        # the holder's pod ("" = none): degraded-read gathers hedge
        # pod-anti-affine (pod members stall together)
        mesh_pod=getattr(n, "mesh_pod", ""),
    )
