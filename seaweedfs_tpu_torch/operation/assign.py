"""Assign a file id from the master (reference: operation/assign_file_id.go:37-80);
a copy of seaweedfs_tpu/operation/assign.py over the port's RPC plane."""
from __future__ import annotations

from dataclasses import dataclass

from ..pb import Stub, channel, master_pb2, server_address


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    grpc_port: int
    count: int
    replicas: list[tuple[str, str]]  # (url, public_url)
    auth: str = ""  # the master-signed write jwt (security/jwt.py)

    def fid_for(self, index: int) -> str:
        """fid of the index-th file in a count>1 assignment: 'vid,key_N'."""
        return self.fid if index == 0 else f"{self.fid}_{index}"


async def assign(
    master: str,
    count: int = 1,
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    data_center: str = "",
    disk_type: str = "",
) -> AssignResult:
    stub = Stub(channel(server_address.grpc_address(master)), master_pb2, "Seaweed")
    resp = await stub.Assign(
        master_pb2.AssignRequest(
            count=count,
            collection=collection,
            replication=replication,
            ttl=ttl,
            data_center=data_center,
            disk_type=disk_type,
        ),
        timeout=10.0,  # an assign is a metadata round-trip
    )
    if resp.error:
        raise RuntimeError(f"assign failed: {resp.error}")
    return AssignResult(
        fid=resp.fid,
        url=resp.location.url,
        public_url=resp.location.public_url,
        grpc_port=resp.location.grpc_port,
        count=resp.count,
        replicas=[(r.url, r.public_url) for r in resp.replicas],
        auth=resp.auth,
    )
