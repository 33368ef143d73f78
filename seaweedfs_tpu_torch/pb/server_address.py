"""ServerAddress conventions (reference: weed/pb/server_address.go; a copy
of seaweedfs_tpu/pb/server_address.py).

A server is addressed as `host:port` for HTTP; its gRPC listener defaults
to `port + 10000` unless an explicit `host:port.grpc_port` form is used.
"""
from __future__ import annotations

GRPC_PORT_DELTA = 10000


def parse(address: str) -> tuple[str, int, int]:
    """'host:port[.grpc]' -> (host, http_port, grpc_port)."""
    host, _, rest = address.rpartition(":")
    if "." in rest:
        port_s, grpc_s = rest.split(".", 1)
        return host, int(port_s), int(grpc_s)
    port = int(rest)
    return host, port, port + GRPC_PORT_DELTA


def http_address(address: str) -> str:
    host, port, _ = parse(address)
    return f"{host}:{port}"


def grpc_address(address: str) -> str:
    host, _, grpc_port = parse(address)
    return f"{host}:{grpc_port}"


def to_grpc_port(http_port: int) -> int:
    return http_port + GRPC_PORT_DELTA
