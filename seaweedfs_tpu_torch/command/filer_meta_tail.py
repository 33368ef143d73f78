"""`filer.meta.tail` — print filer metadata events as JSON lines
(reference: weed/command/filer_meta_tail.go; a copy of
seaweedfs_tpu/command/filer_meta_tail.py over the port's RPC plane)."""
from __future__ import annotations

import json

NAME = "filer.meta.tail"
HELP = "tail filer metadata change events as JSON lines"
STDOUT_STREAM = True  # piping into head/less is expected


def add_args(p) -> None:
    p.add_argument("-filer", required=True, help="filer host:port")
    p.add_argument("-pathPrefix", default="", help="only events under this path")
    p.add_argument(
        "-timeAgo", default="0s",
        help="replay events newer than this before tailing (e.g. 1h)",
    )
    p.add_argument(
        "-timeoutSec", type=float, default=0,
        help="stop after this many seconds (0 = follow forever)",
    )


def event_to_dict(ev) -> dict:
    note = ev.event_notification
    doc = {"directory": ev.directory, "ts_ns": ev.ts_ns}
    if note.HasField("old_entry"):
        doc["old_entry"] = {"name": note.old_entry.name}
    if note.HasField("new_entry"):
        e = note.new_entry
        doc["new_entry"] = {
            "name": e.name,
            "is_directory": e.is_directory,
            "size": e.attributes.file_size,
            "chunks": len(e.chunks),
        }
    if note.new_parent_path:
        doc["new_parent_path"] = note.new_parent_path
    return doc


async def run(args) -> None:
    import asyncio
    import time

    from ..pb import Stub, channel, filer_pb2, server_address
    from ..shell.command_volume import parse_duration

    # -timeAgo 0s means "from now" — NOT a full-history replay
    ago = parse_duration(args.timeAgo)
    since_ns = time.time_ns() - int(ago * 1e9)

    stub = Stub(
        channel(server_address.grpc_address(args.filer)),
        filer_pb2,
        "SeaweedFiler",
    )

    async def tail():
        async for ev in stub.SubscribeMetadata(
            filer_pb2.SubscribeMetadataRequest(
                client_name="filer.meta.tail",
                path_prefix=args.pathPrefix,
                since_ns=since_ns,
            )
        ):
            print(json.dumps(event_to_dict(ev)))

    if args.timeoutSec > 0:
        try:
            await asyncio.wait_for(tail(), args.timeoutSec)
        except asyncio.TimeoutError:
            pass
    else:
        await tail()
