"""Tail a volume's appends from another volume server (a copy of
seaweedfs_tpu/operation/tail_volume.py; reference: operation/tail_volume.go
TailVolumeFromSource), over the port's RPC plane.

The sender streams every record appended after `since_ns` as
(needle_header, needle_body) chunks; bodies of large needles span several
messages, each repeating the header, with is_last_chunk on the final one.
An empty header with is_last_chunk set is a keepalive.
"""
from __future__ import annotations

from ..pb import Stub, channel, server_address, volume_server_pb2
from ..storage.needle import CURRENT_VERSION, Needle


async def tail_volume_from_source(
    source: str,
    vid: int,
    since_ns: int,
    idle_timeout_seconds: int,
    fn,
    version: int = CURRENT_VERSION,
) -> int:
    """Apply `await fn(needle)` for each record tailed from `source`
    (host:port or host:port.grpcport).  Returns the last processed
    append_at_ns (the resume cursor)."""
    stub = Stub(
        channel(server_address.grpc_address(source)),
        volume_server_pb2,
        "VolumeServer",
    )
    body = bytearray()
    last_ns = since_ns
    # tailing a growing volume is a long-lived stream on purpose: the
    # sender's idle_timeout_seconds bounds a silent peer, and the caller
    # owns the overall lifetime
    async for resp in stub.VolumeTailSender(
        volume_server_pb2.VolumeTailSenderRequest(
            volume_id=vid,
            since_ns=since_ns,
            idle_timeout_seconds=idle_timeout_seconds,
        )
    ):
        if not resp.needle_header:
            continue  # keepalive
        body += resp.needle_body
        if resp.is_last_chunk:
            n = Needle.from_bytes(
                bytes(resp.needle_header) + bytes(body), version, verify=False
            )
            body.clear()
            await fn(n)
            last_ns = n.append_at_ns or last_ns
    return last_ns
