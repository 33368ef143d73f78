"""`master` — run a master server (reference: weed/command/master.go).

Port of seaweedfs_tpu/command/master.py for the flags one master without
raft serves, with the reference's spellings:

    python3 -m seaweedfs_tpu_torch master -ip 127.0.0.1 -port 9333 \\
        -volumeSizeLimitMB 30720 -defaultReplication 000

The master does no device work.  `-peers`, `-mdir`, the -ec.repair.*
flags, vacuum and the incident plane's flags wait for ROADMAP A4c.
"""
from __future__ import annotations

import asyncio
import logging

NAME = "master"
HELP = "start a master server"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1", help="listen address")
    p.add_argument("-port", type=int, default=9333, help="http port")
    p.add_argument(
        "-port.grpc", dest="grpc_port", type=int, default=0,
        help="RPC port (default: port+10000)",
    )
    p.add_argument(
        "-volumeSizeLimitMB", dest="volume_size_limit_mb", type=int,
        default=30 * 1024, help="roll to a new volume past this size",
    )
    p.add_argument(
        "-defaultReplication", dest="default_replication", default="000",
        help="XYZ replica placement when an assign doesn't specify one",
    )
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=int, default=5)


def build_server(args):
    """A MasterServer from the parsed flags (not started)."""
    from ..server.master import MasterServer
    from ..storage import types as storage_types

    if args.volume_size_limit_mb * 1024 * 1024 > storage_types.MAX_POSSIBLE_VOLUME_SIZE:
        # volumes past the 4-byte 32GB address cap need 5-byte needle-map
        # offsets (reference 5BytesOffset build tag) — a deployment-wide
        # mode every node must share
        storage_types.set_offset_size(5)
    return MasterServer(
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpc_port,
        volume_size_limit_mb=args.volume_size_limit_mb,
        default_replication=args.default_replication,
        pulse_seconds=args.pulse_seconds,
    )


async def run(args) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ms = build_server(args)
    await ms.start()
    try:
        await asyncio.Event().wait()  # serve until interrupted
    finally:
        await ms.stop()
