"""Volume location lookup (reference: operation/lookup.go); a copy of
seaweedfs_tpu/operation/lookup.py over the port's RPC plane."""
from __future__ import annotations

from ..pb import Stub, channel, master_pb2, server_address


async def lookup_file_id(master: str, fid: str) -> list[str]:
    """fid -> list of full data URLs for it."""
    urls, _ = await lookup_file_id_with_auth(master, fid)
    return urls


async def lookup_file_id_with_auth(master: str, fid: str) -> tuple[list[str], str]:
    """fid -> (full data URLs, master-signed write jwt for that fid).  The
    token authorizes a delete or overwrite on the volume servers when the
    cluster runs with a jwt signing key (LookupVolume auth, reference
    master_grpc_server_volume.go)."""
    stub = Stub(channel(server_address.grpc_address(master)), master_pb2, "Seaweed")
    resp = await stub.LookupVolume(
        master_pb2.LookupVolumeRequest(volume_or_file_ids=[fid]),
        timeout=10.0,
    )
    entry = resp.volume_id_locations[0]
    if entry.error:
        return [], ""
    return [f"http://{l.url}/{fid}" for l in entry.locations], entry.auth
