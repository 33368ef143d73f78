"""Protobuf schemas and the RPC plane of the port.

The reference's `.proto` files are copied byte for byte (filer.proto,
master.proto, raft.proto, volume_server.proto); `wire.py` builds their message classes
from the text at import time and speaks protobuf's binary wire format by
hand, and `rpc.py` carries those messages over asyncio streams in frames
of its own (not gRPC's HTTP/2).  `filer_pb2`, `master_pb2`, `raft_pb2`
and `volume_server_pb2` stand where the reference imports protoc's
generated modules, with the same class names.
"""
from . import server_address, wire

filer_pb2 = wire.load("filer.proto", "seaweedfs_tpu_torch.pb.filer_pb2")
master_pb2 = wire.load("master.proto", "seaweedfs_tpu_torch.pb.master_pb2")
raft_pb2 = wire.load("raft.proto", "seaweedfs_tpu_torch.pb.raft_pb2")
volume_server_pb2 = wire.load(
    "volume_server.proto", "seaweedfs_tpu_torch.pb.volume_server_pb2"
)

from .rpc import (  # noqa: E402 — rpc reads the message modules above
    RpcError,
    RpcServer,
    StatusCode,
    Stub,
    channel,
    close_all_channels,
    sync_channel_cached,
)

__all__ = [
    "RpcError",
    "RpcServer",
    "StatusCode",
    "Stub",
    "channel",
    "close_all_channels",
    "filer_pb2",
    "master_pb2",
    "raft_pb2",
    "server_address",
    "sync_channel_cached",
    "volume_server_pb2",
    "wire",
]
