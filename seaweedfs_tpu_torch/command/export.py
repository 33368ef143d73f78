"""`export` — dump a volume's live needles to a tar archive
(reference: weed/command/export.go; a copy of
seaweedfs_tpu/command/export.py over the port's storage/volume.py)."""
from __future__ import annotations

NAME = "export"
HELP = "export a volume's needles to a tar file"


def add_args(p) -> None:
    p.add_argument("-dir", default=".", help="data directory")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument(
        "-o", dest="output", default="", help="output tar (default vol_N.tar)"
    )
    p.add_argument(
        "-deleted", action="store_true", help="include deleted needles too"
    )


async def run(args) -> None:
    import io
    import tarfile

    from ..storage.volume import Volume

    out = args.output or f"vol_{args.volume_id}.tar"
    v = Volume(args.dir, args.volume_id, args.collection)
    n = 0
    try:
        with tarfile.open(out, "w") as tar:
            for offset, needle in v.scan(include_deleted=args.deleted):
                if not args.deleted:
                    # raw .dat order includes superseded/deleted records;
                    # only the map-current ones are live
                    loc = v.nm.get(needle.id)
                    if loc is None or loc[0] != offset:
                        continue
                name = (
                    needle.name.decode(errors="replace")
                    if needle.name
                    else f"{args.volume_id:x}_{needle.id:x}"
                )
                # stored names are untrusted: no separators or parent
                # refs may reach the archive (tar path traversal)
                name = name.replace("/", "_").replace("\\", "_")
                if name in (".", ".."):
                    name = "_" + name
                # keep fid-unique paths even when filenames repeat
                arcname = f"{needle.id:x}_{needle.cookie:x}/{name}"
                info = tarfile.TarInfo(arcname)
                info.size = len(needle.data)
                info.mtime = needle.last_modified or 0
                tar.addfile(info, io.BytesIO(bytes(needle.data)))
                n += 1
    finally:
        v.close()
    print(f"exported {n} needles from volume {args.volume_id} to {out}")
