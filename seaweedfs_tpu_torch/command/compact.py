"""`compact` — offline-vacuum a volume
(reference: weed/command/compact.go; a copy of
seaweedfs_tpu/command/compact.py over the port's storage/vacuum.py)."""
from __future__ import annotations

NAME = "compact"
HELP = "compact an offline volume in place (reclaim deleted space)"


def add_args(p) -> None:
    p.add_argument("-dir", default=".", help="data directory")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")


async def run(args) -> None:
    import os

    from ..storage.vacuum import vacuum
    from ..storage.volume import Volume

    v = Volume(args.dir, args.volume_id, args.collection)
    before = os.path.getsize(v.dat_path)
    ratio = vacuum(v)
    after = os.path.getsize(v.dat_path)
    v.close()
    print(
        f"volume {args.volume_id}: {before} -> {after} bytes "
        f"(garbage ratio was {ratio:.2%})"
    )
