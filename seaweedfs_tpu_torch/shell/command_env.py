"""CommandEnv: the shell's handle on the cluster.

A copy of seaweedfs_tpu/shell/command_env.py over the port's RPC plane.
Reference:
weed/shell/commands.go:51-89 — holds the master stub, the exclusive admin
lock lease, and option state shared by all commands.
"""
from __future__ import annotations

import io
import json
from dataclasses import dataclass, field

from ..pb import Stub, channel, master_pb2, server_address, volume_server_pb2

LOCK_NAME = "admin"


@dataclass
class TopoNode:
    """Flattened view of one volume server from VolumeList's topology JSON."""

    url: str
    grpc_port: int
    data_center: str
    rack: str
    volumes: list[dict] = field(default_factory=list)
    ec_shards: list[dict] = field(default_factory=list)
    max_volume_counts: dict = field(default_factory=dict)
    # host failure domain: the node's pod id ("" = not in a pod)
    mesh_pod: str = ""

    @property
    def grpc_address(self) -> str:
        host = self.url.rsplit(":", 1)[0]
        return f"{host}:{self.grpc_port}"

    def free_slots(self, disk_type: str = "") -> int:
        from ..storage.ec import TOTAL_SHARDS

        used = sum(
            1
            for v in self.volumes
            if not disk_type or v.get("disk_type", "hdd") == disk_type
        )
        used += (
            sum(
                bin(s["ec_index_bits"]).count("1")
                for s in self.ec_shards
                if not disk_type or s.get("disk_type", "hdd") == disk_type
            )
            + TOTAL_SHARDS - 1
        ) // TOTAL_SHARDS
        if disk_type:
            return self.max_volume_counts.get(disk_type, 0) - used
        return sum(self.max_volume_counts.values()) - used


def topo_nodes_from_info(info: dict) -> list[TopoNode]:
    """Flatten a Topology.to_info() snapshot (VolumeList's JSON) into
    TopoNodes."""
    nodes = []
    for dc in info.get("data_centers", []):
        for rack in dc.get("racks", []):
            for n in rack.get("nodes", []):
                nodes.append(
                    TopoNode(
                        url=n["id"],
                        grpc_port=n.get("grpc_port", 0),
                        data_center=dc["id"],
                        rack=rack["id"],
                        volumes=n.get("volumes", []),
                        ec_shards=n.get("ec_shards", []),
                        max_volume_counts=n.get("max_volume_counts", {}),
                        mesh_pod=n.get("mesh_pod", ""),
                    )
                )
    return nodes


class CommandEnv:
    def __init__(self, masters: list[str], out: io.TextIOBase | None = None):
        self.masters = masters
        self.out = out
        self.lock_token = 0
        self.lock_ts = 0
        self.option: dict = {}

    def write(self, *args) -> None:
        text = " ".join(str(a) for a in args)
        if self.out is not None:
            self.out.write(text + "\n")
        else:
            print(text)

    # -- stubs ---------------------------------------------------------------

    @property
    def master_stub(self) -> Stub:
        return Stub(
            channel(server_address.grpc_address(self.masters[0])),
            master_pb2,
            "Seaweed",
        )

    def volume_stub(self, grpc_address: str) -> Stub:
        return Stub(channel(grpc_address), volume_server_pb2, "VolumeServer")

    async def find_filer(self) -> str:
        """One live filer's host:port from the master's cluster registry."""
        resp = await self.master_stub.ListClusterNodes(
            master_pb2.ListClusterNodesRequest(client_type="filer")
        )
        if not resp.cluster_nodes:
            raise RuntimeError("no filer registered with the master")
        return resp.cluster_nodes[0].address

    def filer_stub(self, filer_address: str) -> Stub:
        from ..pb import filer_pb2

        return Stub(
            channel(server_address.grpc_address(filer_address)),
            filer_pb2,
            "SeaweedFiler",
        )

    # -- admin lock (commands.go:78, confirmIsLocked) ------------------------

    async def acquire_lock(self, client_name: str = "shell", message: str = "") -> None:
        resp = await self.master_stub.LeaseAdminToken(
            master_pb2.LeaseAdminTokenRequest(
                previous_token=self.lock_token,
                previous_lock_time=self.lock_ts,
                lock_name=LOCK_NAME,
                client_name=client_name,
                message=message,
            )
        )
        self.lock_token, self.lock_ts = resp.token, resp.lock_ts_ns

    async def release_lock(self) -> None:
        if self.lock_token:
            await self.master_stub.ReleaseAdminToken(
                master_pb2.ReleaseAdminTokenRequest(
                    previous_token=self.lock_token,
                    previous_lock_time=self.lock_ts,
                    lock_name=LOCK_NAME,
                )
            )
            self.lock_token = self.lock_ts = 0

    def confirm_is_locked(self) -> None:
        if not self.lock_token:
            raise RuntimeError(
                "lock is lost, or this command needs to be executed inside `lock` ... `unlock`"
            )

    # -- topology snapshot ---------------------------------------------------

    async def collect_topology(self) -> tuple[list[TopoNode], int]:
        """-> (nodes, volume_size_limit_mb) from master VolumeList
        (collectTopologyInfo command_ec_common.go:208)."""
        resp = await self.master_stub.VolumeList(master_pb2.VolumeListRequest())
        info = json.loads(resp.topology_info_json)
        return topo_nodes_from_info(info), resp.volume_size_limit_mb
