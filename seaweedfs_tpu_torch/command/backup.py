"""`backup` — incremental local backup of a remote volume
(reference: weed/command/backup.go; a copy of
seaweedfs_tpu/command/backup.py over the port's operation/tail_volume.py).

First run copies every record via the tail stream; later runs resume
from the locally-recorded append timestamp and pull only the delta.
The source's VolumeStatus supplies version/ttl/replication for the
local superblock and the compaction revision — a revision change means
the source was vacuumed (tombstones purged), so the local copy resets
and resyncs in full, exactly like the reference.
"""
from __future__ import annotations

import json

NAME = "backup"
HELP = "incrementally back up a remote volume to local .dat/.idx files"


def add_args(p) -> None:
    p.add_argument(
        "-server", dest="server", required=True,
        help="volume server host:port[.grpc]",
    )
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-dir", default=".", help="local backup directory")


async def run(args) -> None:
    import os

    from ..operation import tail_volume_from_source
    from ..pb import Stub, channel, server_address, volume_server_pb2
    from ..storage import types as t
    from ..storage.volume import Volume

    stub = Stub(
        channel(server_address.grpc_address(args.server)),
        volume_server_pb2,
        "VolumeServer",
    )
    status = await stub.VolumeStatus(
        volume_server_pb2.VolumeStatusRequest(volume_id=args.volume_id)
    )

    os.makedirs(args.dir, exist_ok=True)
    base = Volume.base_name(args.dir, args.volume_id, args.collection)
    cursor_path = base + ".backup_ns"
    since_ns = 0
    prev_revision = -1
    if os.path.exists(cursor_path):
        from ..utils.aiofile import read_file_text

        cur = json.loads(await read_file_text(cursor_path) or "{}")
        since_ns = int(cur.get("since_ns", 0))
        prev_revision = int(cur.get("compact_revision", -1))

    if prev_revision not in (-1, status.compact_revision):
        # the source was vacuumed: records (and tombstones) before the
        # compaction are gone from its stream — start over
        print(
            f"volume {args.volume_id}: source compacted "
            f"(rev {prev_revision} -> {status.compact_revision}); full resync"
        )
        for ext in (".dat", ".idx", ".note"):
            if os.path.exists(base + ext):
                os.remove(base + ext)
        since_ns = 0

    v = Volume(
        args.dir, args.volume_id, args.collection,
        replica_placement=t.ReplicaPlacement.parse(status.replication or "000"),
        ttl=t.TTL.parse(status.ttl if status.ttl != "0" else ""),
        version=status.version or 3,
    )
    applied = 0

    async def apply(n):
        nonlocal applied
        if t.size_is_valid(n.size):
            v.append_needle(n)
        else:
            v.delete(n.id)
        applied += 1

    try:
        last_ns = await tail_volume_from_source(
            args.server, args.volume_id, since_ns,
            idle_timeout_seconds=1,  # drain then stop (one-shot backup)
            fn=apply, version=v.version,
        )
    finally:
        v.close()
    from ..utils.aiofile import write_file_text

    await write_file_text(cursor_path, json.dumps(
        {"since_ns": last_ns, "compact_revision": status.compact_revision}
    ))
    print(
        f"volume {args.volume_id}: applied {applied} records "
        f"(cursor {since_ns} -> {last_ns}) into {args.dir}"
    )
