"""`master.follower` — run a lookup-only master follower (reference:
weed/command/master_follower.go; the port of
seaweedfs_tpu/command/master_follower.py):

    python3 -m seaweedfs_tpu_torch master.follower -port 9334 \
        -masters 10.0.0.1:9333,10.0.0.2:9333,10.0.0.3:9333

It mirrors the leader's volume locations over KeepConnected and answers
/dir/lookup, LookupVolume and /cluster/status itself; Assign, Statistics,
VolumeList and ListClusterNodes go to the leader.
"""
from __future__ import annotations

NAME = "master.follower"
HELP = "run a read-only master follower serving volume lookups"


def add_args(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9334)
    p.add_argument("-port.grpc", dest="grpc_port", type=int, default=0)
    p.add_argument(
        "-masters", default="127.0.0.1:9333",
        help="comma-separated master host:port list to follow",
    )


async def run(args) -> None:
    import asyncio

    from ..server.master_follower import MasterFollowerServer

    f = MasterFollowerServer(
        masters=args.masters.split(","),
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpc_port,
    )
    await f.start()
    print(f"master follower ready on {f.url} following {args.masters}",
          flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await f.stop()
